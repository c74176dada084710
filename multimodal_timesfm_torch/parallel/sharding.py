"""Parameter sharding rules: tensor parallelism for the backbone matmuls.

Counterpart of ``multimodal_timesfm_tpu/parallel/sharding.py``, with JAX's
naming rules on the port's module names. A ``layers.Dense`` is named by its
attribute (its "parent" in the JAX tree); the weight is (out, in), JAX's
kernel (in, out):

  * column-parallel (JAX shards the kernel's last dim): ``ffn_up``, ``hidden``
    (the residual blocks) and Chronos-2's ``q``, ``k``, ``v``; torch dim 0 of
    the weight and of the bias. The input is replicated, the output this
    rank's block of features (whole heads for q, k, v);
  * row-parallel (JAX shards the kernel's second-last dim): ``ffn_down``,
    ``out`` and ``output``; torch dim 1 of the weight, the bias replicated and
    added once, after the partial products are summed over the model axis;
  * everything else replicated, TimesFM's fused ``qkv`` included (its q|k|v
    thirds align with shard borders only when mp is a multiple of 3), so its
    attention runs at all heads on every rank and ``out`` reads this rank's
    block of a replicated input; the fusion MLP, norms and tables too.

``shard_params`` keeps each rank's block as the parameter's own (plain)
tensor and switches the Dense to its parallel form (``layers.Dense.forward``;
the collectives are ``parallel/collectives.py``'s). Where GSPMD pads a dim
that the model axis does not divide, the port raises, naming the parameter.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from multimodal_timesfm_torch.parallel.collectives import ModelAxis
from multimodal_timesfm_torch.parallel.mesh import MODEL_AXIS, axis_group, axis_rank, axis_size, check_mesh

_COLUMN = ("ffn_up", "hidden", "q", "k", "v")
_ROW = ("ffn_down", "out", "output")


def _kind(name: str, module: nn.Module) -> str | None:
    """"column", "row" or None (replicated) for a module at dotted path ``name``."""
    from multimodal_timesfm_torch.models.layers import Dense

    if not isinstance(module, Dense):
        return None
    parent = name.rsplit(".", 1)[-1]
    if parent in _COLUMN:
        return "column"
    if parent in _ROW:
        return "row"
    return None


def param_specs(module: nn.Module) -> dict[str, int | None]:
    """Parameter name -> the torch dim sharded over the model axis, or None (replicated)."""
    specs = {name: None for name, _ in module.named_parameters()}
    for name, sub in module.named_modules():
        kind = _kind(name, sub)
        prefix = f"{name}." if name else ""
        if kind == "column":
            specs[prefix + "weight"] = 0
            if sub.bias is not None:
                specs[prefix + "bias"] = 0
        elif kind == "row":
            specs[prefix + "weight"] = 1
    return specs


def check_divisible(module: nn.Module, mp: int) -> None:
    """Raise ``ValueError`` naming the first parameter whose sharded dim ``mp`` does not
    divide, or the attention whose heads it does not divide (Chronos-2's q, k, v shard by
    head). GSPMD pads such a dim; the port does not."""
    params = dict(module.named_parameters())
    for name, dim in param_specs(module).items():
        if dim is not None and params[name].shape[dim] % mp != 0:
            raise ValueError(
                f"{name}: dim {dim} of size {params[name].shape[dim]} does not divide over the model "
                f"axis of {mp} ranks (uneven shards are not supported)"
            )
    for name, sub in module.named_modules():
        attn = getattr(sub, "attn", None)
        if hasattr(attn, "q") and sub.num_heads % mp != 0:
            raise ValueError(
                f"{name}: {sub.num_heads} attention heads do not divide over the model axis of {mp} ranks"
            )


def shard_params(module: nn.Module, mesh: Any) -> nn.Module:
    """Shard ``module`` over the mesh's model axis in place (nothing to do at mp = 1);
    returns it. Every rank of the model axis must call it, on the same module."""
    check_mesh(mesh, "shard_params")
    mp = axis_size(mesh, MODEL_AXIS)
    check_divisible(module, mp)
    if mp == 1:
        return module
    axis = ModelAxis(axis_group(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS), mp)
    with torch.no_grad():
        for name, sub in module.named_modules():
            kind = _kind(name, sub)
            if kind is None:
                continue
            if sub.parallel is not None:
                raise ValueError(f"{name} is sharded already")
            sub.weight.data = axis.block(sub.weight.data, 0 if kind == "column" else 1).clone()
            if kind == "column" and sub.bias is not None:
                sub.bias.data = axis.block(sub.bias.data, 0).clone()
            sub.parallel = (kind, axis)
    return module


def sharded_params(module: nn.Module) -> dict[nn.Parameter, tuple[int, ModelAxis]]:
    """Each sharded parameter of ``module`` -> (its sharded torch dim, its model axis)."""
    out = {}
    for sub in module.modules():
        parallel = getattr(sub, "parallel", None)
        if parallel is None:
            continue
        kind, axis = parallel
        out[sub.weight] = (0 if kind == "column" else 1, axis)
        if kind == "column" and sub.bias is not None:
            out[sub.bias] = (0, axis)
    return out


def gather_params(
    module: nn.Module, values: dict[nn.Parameter, torch.Tensor] | None = None
) -> dict[nn.Parameter, torch.Tensor]:
    """Each parameter of ``module`` -> its whole tensor (or, with ``values``, the whole
    tensor of the value paired with it: an optimizer moment), the blocks of a sharded one
    gathered over its model axis. Every rank of the axis must call it."""
    shards = sharded_params(module)
    out = {}
    for p in module.parameters():
        t = (p if values is None else values[p]).detach()
        if p in shards:
            dim, axis = shards[p]
            parts = [torch.empty_like(t) for _ in range(axis.size)]
            dist.all_gather(parts, t.contiguous(), group=axis.group)
            t = torch.cat(parts, dim)
        out[p] = t
    return out


def local_blocks(
    module: nn.Module, values: dict[nn.Parameter, torch.Tensor]
) -> dict[nn.Parameter, torch.Tensor]:
    """``values`` (whole tensors, one per parameter) cut to this rank's blocks, as
    ``shard_params`` cut the parameters."""
    shards = sharded_params(module)
    out = {}
    for p, t in values.items():
        if p in shards:
            dim, axis = shards[p]
            t = axis.block(t, dim).contiguous()
        out[p] = t
    return out


def unshard_params(module: nn.Module) -> nn.Module:
    """Gather every sharded parameter of ``module`` whole again and restore the plain
    Dense forms, in place; returns it. Every rank of the model axis must call it."""
    whole = gather_params(module)
    with torch.no_grad():
        for p in sharded_params(module):
            p.data = whole[p]
    for sub in module.modules():
        if getattr(sub, "parallel", None) is not None:
            sub.parallel = None
    return module
