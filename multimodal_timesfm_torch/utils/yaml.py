"""YAML utilities (framework-free copy of the JAX package's): the same file formats."""

from __future__ import annotations

from pathlib import Path
from typing import Any, TypeVar

import yaml

T = TypeVar("T")


def load_yaml(path: Path | str) -> dict[str, Any]:
    """Load a YAML file into a raw dictionary.

    Raises:
        FileNotFoundError: If the file doesn't exist.
        yaml.YAMLError: If the YAML file is malformed.
        ValueError: If the file does not contain a top-level mapping.
    """
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    if not isinstance(data, dict):
        raise ValueError(f"Expected YAML file to contain a mapping, got {type(data).__name__}")
    return data


def parse_yaml(path: Path | str, cls: type[T]) -> T:
    """Parse a YAML file and construct ``cls`` from the top-level mapping."""
    return cls(**load_yaml(path))
