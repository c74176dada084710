"""Weight bridge: the JAX package's params tree, as numpy arrays, into the port's modules.

The JAX tree of a ``MultimodalDecoder`` is ``{"adapter": ..., "fusion":
{"layers": [{"kernel"}, ...]}}``. Two layout rules differ from the modules:

  * a JAX dense kernel is (in, out); ``Dense.weight`` is (out, in);
  * the transformer stack is one tree whose leaves carry a leading layer
    axis (``adapter/stacked_xf/...``, shape (L, ...)); the port holds L
    layer modules.

The bridge is strict: a leaf that is missing, left over or of the wrong shape
raises ``ValueError`` naming its path. Any leaf that ``np.asarray`` accepts
(numpy or JAX arrays) is taken.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

_STACK = ("adapter", "stacked_xf", "layers")


@dataclasses.dataclass
class _Slot:
    params: list[nn.Parameter]  # one per layer for a stacked leaf, else one
    transpose: bool
    stacked: bool

    @property
    def shape(self) -> tuple[int, ...]:
        shape = tuple(self.params[0].shape)
        if self.transpose:
            shape = shape[::-1]
        return (len(self.params), *shape) if self.stacked else shape


def _slots(module: nn.Module) -> dict[str, _Slot]:
    """JAX tree path -> the parameters it fills, from the module's parameter names."""
    slots: dict[str, _Slot] = {}
    for name, param in module.named_parameters():
        parts = name.split(".")
        transpose = parts[-1] == "weight"
        if transpose:
            parts[-1] = "kernel"
        stacked = tuple(parts[:3]) == _STACK
        if stacked:
            parts = [*parts[:2], *parts[4:]]
        path = "/".join(parts)
        slot = slots.setdefault(path, _Slot([], transpose, stacked))
        slot.params.append(param)
    return slots


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat: dict[str, Any] = {}
    for key, value in items:
        flat.update(_flatten(value, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def expected_shapes(module: nn.Module) -> dict[str, tuple[int, ...]]:
    """JAX tree path -> leaf shape, for the tree that ``module`` accepts."""
    return {path: slot.shape for path, slot in _slots(module).items()}


def load_jax_params(module: nn.Module, tree: Any) -> None:
    """Copy a JAX params tree into ``module`` (a ``MultimodalDecoder``), strictly."""
    slots = _slots(module)
    flat = _flatten(tree)
    missing = sorted(set(slots) - set(flat))
    extra = sorted(set(flat) - set(slots))
    if missing or extra:
        raise ValueError(f"params tree does not match the module: missing {missing}, extra {extra}")
    arrays = {}
    for path, slot in slots.items():
        arr = np.asarray(flat[path])
        if arr.shape != slot.shape:
            raise ValueError(f"{path}: shape {arr.shape}, expected {slot.shape}")
        arrays[path] = arr.astype(np.float32, copy=False)
    with torch.no_grad():
        for path, slot in slots.items():
            for i, param in enumerate(slot.params):
                arr = arrays[path][i] if slot.stacked else arrays[path]
                if slot.transpose:
                    arr = arr.T
                param.copy_(torch.from_numpy(np.ascontiguousarray(arr)))


def random_jax_params(module: nn.Module, seed: int) -> dict[str, Any]:
    """A JAX-layout params tree for ``module``, drawn with numpy from ``seed``.

    Kernels are Xavier-uniform over their (in, out) fans; the LayerNorm gain
    is ``1 + N(0, 0.05^2)``; every other leaf (biases, RMS gains, per-dim
    query scales) is ``N(0, 0.05^2)``.
    """
    rng = np.random.default_rng(seed)
    tree: dict[str, Any] = {}
    for path, shape in expected_shapes(module).items():
        if path.endswith("/kernel"):
            limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            leaf = rng.uniform(-limit, limit, shape)
        else:
            leaf = rng.normal(0.0, 0.05, shape)
            if path.endswith("ffn_norm/scale"):
                leaf += 1.0
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf.astype(np.float32)
    return _lists(tree)


def _lists(node: Any) -> Any:
    """Turn dicts keyed "0".."n-1" (the fusion layers) back into lists."""
    if not isinstance(node, dict):
        return node
    out = {key: _lists(value) for key, value in node.items()}
    if out and all(key.isdigit() for key in out):
        return [out[str(i)] for i in range(len(out))]
    return out
