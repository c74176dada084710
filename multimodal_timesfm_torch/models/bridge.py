"""Weight bridge between the JAX package's params tree, as numpy arrays, and the port's modules.

The JAX tree of a ``MultimodalDecoder`` is ``{"adapter": ..., "fusion":
{"layers": [{"kernel"}, ...]}}``; a subtree (``"adapter"``, ``"fusion"``)
pairs with the child module of that name. Two layout rules differ from the
modules:

  * a JAX dense kernel is (in, out); ``Dense.weight`` is (out, in);
  * the transformer stack is one tree whose leaves carry a leading layer
    axis (``stacked_xf/...``, shape (L, ...)); the port holds L layer
    modules.

``load_jax_params`` reads a tree into a module; ``export_jax_params`` writes
a module's parameters (or tensors paired with them, such as optimizer
moments) back out as a tree. Loading is strict: a leaf that is missing, left
over or of the wrong shape raises ``ValueError`` naming its path. Any leaf
that ``np.asarray`` accepts (numpy or JAX arrays) is taken.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

_STACK = ("stacked_xf", "layers")


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
        at = next((i for i in range(len(parts) - 2) if tuple(parts[i : i + 2]) == _STACK), None)
        stacked = at is not None
        if stacked:
            parts = [*parts[: at + 1], *parts[at + 3 :]]
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


def jax_tree_arrays(module: nn.Module, tree: Any) -> dict[nn.Parameter, np.ndarray]:
    """Each parameter of ``module`` -> its fp32 array cut from a JAX-layout tree, strictly."""
    slots = _slots(module)
    flat = _flatten(tree)
    missing = sorted(set(slots) - set(flat))
    extra = sorted(set(flat) - set(slots))
    if missing or extra:
        raise ValueError(f"params tree does not match the module: missing {missing}, extra {extra}")
    out: dict[nn.Parameter, np.ndarray] = {}
    for path, slot in slots.items():
        arr = np.asarray(flat[path])
        if arr.shape != slot.shape:
            raise ValueError(f"{path}: shape {arr.shape}, expected {slot.shape}")
        arr = arr.astype(np.float32, copy=False)
        for i, param in enumerate(slot.params):
            leaf = arr[i] if slot.stacked else arr
            out[param] = np.ascontiguousarray(leaf.T if slot.transpose else leaf)
    return out


def load_jax_params(module: nn.Module, tree: Any) -> None:
    """Copy a JAX params tree into ``module`` (a ``MultimodalDecoder`` or one of its subtrees)."""
    arrays = jax_tree_arrays(module, tree)
    with torch.no_grad():
        for param, arr in arrays.items():
            param.copy_(torch.from_numpy(arr))


def export_jax_params(
    module: nn.Module, values: dict[nn.Parameter, torch.Tensor] | None = None
) -> dict[str, Any]:
    """``module``'s parameters as a JAX-layout tree of fp32 numpy arrays.

    Kernels go back to (in, out) and the stacked layers get their leading L
    axis. ``values`` maps each parameter to a tensor of its shape to export in
    its place (an optimizer moment, a gradient).
    """
    tree: dict[str, Any] = {}
    for path, slot in _slots(module).items():
        leaves = []
        for param in slot.params:
            t = param if values is None else values[param]
            arr = t.detach().to("cpu", torch.float32).numpy()
            leaves.append(arr.T if slot.transpose else arr)
        _put(tree, path, np.stack(leaves) if slot.stacked else np.ascontiguousarray(leaves[0]))
    return _lists(tree)


def _put(tree: dict[str, Any], path: str, leaf: Any) -> None:
    node = tree
    parts = path.split("/")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = leaf


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
        _put(tree, path, leaf.astype(np.float32))
    return _lists(tree)


def _lists(node: Any) -> Any:
    """Turn dicts keyed "0".."n-1" (the fusion layers) back into lists."""
    if not isinstance(node, dict):
        return node
    out = {key: _lists(value) for key, value in node.items()}
    if out and all(key.isdigit() for key in out):
        return [out[str(i)] for i in range(len(out))]
    return out
