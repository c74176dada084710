"""Weight bridge between the JAX package's params tree, as numpy arrays, and the port's modules.

The JAX tree of a ``MultimodalDecoder`` is ``{"adapter": ..., "fusion":
{"layers": [{"kernel"}, ...]}}``; a subtree (``"adapter"``, ``"fusion"``)
pairs with the child module of that name. Two layout rules differ from the
modules:

  * a JAX dense kernel is (in, out); ``Dense.weight`` is (out, in);
  * a transformer stack is one tree whose leaves carry a leading layer
    axis, shape (L, ...); the port holds L layer modules. TimesFM's stack is
    ``stacked_xf/...`` (the port's ``stacked_xf.layers.<i>``), Chronos-2's
    ``encoder/layers/...`` (the port's ``encoder.layers.<i>``). Any other
    ``layers`` list, such as the fusion MLP's, stays a list.

A stack folded for training a frozen backbone (``models/layers.py``
``fold_seq1_attention``, ``fold_frozen_affines``) has JAX's folded layout:
``attn/vo`` in place of ``attn/qkv``, ``attn/out`` and ``per_dim_scale``, and
empty ``attn_norm`` and ``ffn_norm`` dicts.

Leaves that are not dense kernels keep their layout: a table held as a plain
``nn.Parameter`` (Chronos-2's ``shared`` [REG] table and ``rel_pos_bias``, the
text encoders' embedding tables) is not named ``weight`` and so is not
transposed.

The text encoders' trees (``text/bert.py``, ``text/modernbert.py``, as the
JAX package's ``init_bert`` and ``init_modernbert`` lay them out) go through
the same rules: their ``layers`` list stays a list, and ModernBERT's layer 0
has no ``attn_norm`` because the module has none.

``load_jax_params`` reads a tree into a module; ``export_jax_params`` writes
a module's parameters (or tensors paired with them, such as optimizer
moments) back out as a tree. Loading is strict: a leaf that is missing, left
over or of the wrong shape raises ``ValueError`` naming its path. Any leaf
that ``np.asarray`` accepts (numpy or JAX arrays) is taken, and tensors
(the bf16 leaves of an unpickled JAX checkpoint).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from multimodal_timesfm_torch.models.layers import LayerNorm, RMSNorm

# (parent, "layers") -> how many of the two names the JAX path keeps: the
# module list's index is always dropped, "layers" only under ``stacked_xf``.
_STACKS = {("stacked_xf", "layers"): 1, ("encoder", "layers"): 2}


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


def _jax_path(name: str) -> tuple[str, bool]:
    """(JAX tree path, whether it is a stacked leaf) of a dotted module or parameter name."""
    parts = name.split(".")
    at = next((i for i in range(len(parts) - 2) if tuple(parts[i : i + 2]) in _STACKS), None)
    if at is not None:
        keep = _STACKS[tuple(parts[at : at + 2])]
        parts = [*parts[: at + keep], *parts[at + 3 :]]
    return "/".join(parts), at is not None


def _slots(module: nn.Module) -> dict[str, _Slot]:
    """JAX tree path -> the parameters it fills, from the module's parameter names."""
    slots: dict[str, _Slot] = {}
    for name, param in module.named_parameters():
        transpose = name.endswith(".weight") or name == "weight"
        if transpose:
            name = name[: -len("weight")] + "kernel"
        path, stacked = _jax_path(name)
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


def leaf_array(leaf: Any) -> np.ndarray:
    """A tree leaf as a numpy array: a tensor (bf16 upcast to fp32, which is exact) or
    anything ``np.asarray`` takes."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
    return np.asarray(leaf)


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
        arr = leaf_array(flat[path])
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
    for name, sub in module.named_modules():
        if isinstance(sub, (RMSNorm, LayerNorm)) and sub.scale is None:
            # A norm whose affine was folded into the next GEMM: JAX keeps an empty dict.
            _put(tree, _jax_path(name)[0], {})
    return _lists(tree)


def _put(tree: dict[str, Any], path: str, leaf: Any) -> None:
    node = tree
    parts = path.split("/")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = leaf


def random_jax_params(module: nn.Module, seed: int) -> dict[str, Any]:
    """A JAX-layout params tree for ``module``, drawn with numpy from ``seed``.

    Kernels are Xavier-uniform over their (in, out) fans; the gain of a
    ``layers.LayerNorm`` is ``1 + N(0, 0.05^2)``; every other leaf (biases,
    RMS gains, which apply ``1 + scale`` themselves, per-dim query scales,
    tables) is ``N(0, 0.05^2)``.
    """
    layer_norm_gains = {
        id(sub.scale) for sub in module.modules() if isinstance(sub, LayerNorm)
    }
    rng = np.random.default_rng(seed)
    tree: dict[str, Any] = {}
    for path, slot in _slots(module).items():
        shape = slot.shape
        if path.endswith("/kernel"):
            limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            leaf = rng.uniform(-limit, limit, shape)
        else:
            leaf = rng.normal(0.0, 0.05, shape)
            if id(slot.params[0]) in layer_norm_gains:
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
