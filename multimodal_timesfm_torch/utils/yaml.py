"""YAML utilities (framework-free copy of the JAX package's): the same file formats.

PyYAML is imported when a file is read, not with this module. Without it, a
file written as JSON (which is also YAML, and reads the same either way)
still loads; any other file raises ``ImportError`` naming PyYAML.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, TypeVar

T = TypeVar("T")


def load_yaml(path: Path | str) -> dict[str, Any]:
    """Load a YAML file into a raw dictionary.

    Raises:
        FileNotFoundError: If the file doesn't exist.
        yaml.YAMLError: If the YAML file is malformed.
        ImportError: If PyYAML is not installed and the file is not JSON.
        ValueError: If the file does not contain a top-level mapping.
    """
    with open(path, "r") as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            raise ImportError(
                f"PyYAML is not installed and {path} is not JSON; install PyYAML or write the "
                "file as JSON"
            ) from None
    else:
        data = yaml.safe_load(text)
    if not isinstance(data, dict):
        raise ValueError(f"Expected YAML file to contain a mapping, got {type(data).__name__}")
    return data


def parse_yaml(path: Path | str, cls: type[T]) -> T:
    """Parse a YAML file and construct ``cls`` from the top-level mapping."""
    return cls(**load_yaml(path))
