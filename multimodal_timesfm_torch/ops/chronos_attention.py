"""Bidirectional T5 attention over the raw fused qkv projection: Chronos-2's encoder attention.

Counterpart of ``multimodal_timesfm_tpu/ops/chronos_attention.py``. The input
is the (B, S, 3*H*D) output of the encoder's q|k|v projection, head h at
columns h*D of each block, queries NOT scaled (T5 folds the scale into the
weights); ``seg`` is (B, S) int32 attention-group ids, query i attending key
j iff ``seg[b, i] == seg[b, j]`` (the encoder gives every padded token an
id of its own, so every row keeps at least its own key); ``bias`` is the
(H, S, S) fp32 relative-position bias. The output is (B, S, H*D), ready for
the out projection.

Numerics are JAX's kernel's: fp32 logits ``q k^T + bias``, masked to
``finfo(float32).min`` (never ``-inf``), fp32 softmax, the weights rounded to
the compute dtype before an fp32-accumulated PV product, one cast out; the
backward recomputes the weights in fp32 and keeps them unrounded.

``fused_chronos_attention`` is differentiable, a ``torch.library`` custom op
(``torch.ops.mtt.fused_chronos_attention``). On a CUDA tensor its forward
launches the hand-written kernels through ``csrc/chronos_attention.cu``'s
dispatch (B4f; in bf16 at head_dim 64 the persistent route of
``csrc/chronos_attention_short_hopper.cu`` up to 128 tokens, the wgmma route
from 129) and its backward the backward kernels (B4b) through
``csrc/chronos_attention_bwd.cu``'s; on a CPU tensor each runs its plain
version. There is no other fallback. As in JAX's custom VJP, the
residuals are qkv, seg and the bias; the bias gradient is computed only when
the bias needs one (the backbone trains in baseline mode only). The TPU
kernel's block-diagonal pre-tiled bias (``make_rowtile_bias``) is a TPU layout
device and is not carried over: the kernel reads (H, S, S) directly.
"""

from __future__ import annotations

import collections

import torch

from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops.attention import NEG_INF, fold_trials, is_traced
from multimodal_timesfm_torch.ops.qkv_attention import split_heads


def _geometry(qkv: torch.Tensor, bias: torch.Tensor) -> tuple[int, int]:
    """(H, D) from the bias's head axis and qkv's width."""
    heads = bias.shape[0]
    cols = qkv.shape[-1]
    if cols % (3 * heads) != 0:
        raise ValueError(f"qkv has {cols} columns, not a multiple of 3*H = {3 * heads}")
    return heads, cols // (3 * heads)


def _weights(qkv: torch.Tensor, seg: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """fp32 (B, H, S, S) softmax(q k^T + bias), keys of another segment at finfo.min."""
    heads, dim = _geometry(qkv, bias)
    q, k, _ = split_heads(qkv, heads, dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias[None]
    same = seg[:, :, None] == seg[:, None, :]
    return torch.softmax(logits.masked_fill(~same[:, None], NEG_INF), dim=-1)


def plain_chronos_attention(qkv: torch.Tensor, seg: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the B4f kernel (JAX ``_fwd_kernel``).

    Args:
        qkv: (B, S, 3*H*D), queries unscaled.
        seg: (B, S) int32 attention-group ids.
        bias: (H, S, S) fp32.

    Returns:
        (B, S, H*D) in qkv's dtype.
    """
    heads, dim = _geometry(qkv, bias)
    _, _, v = split_heads(qkv, heads, dim)
    w = _weights(qkv, seg, bias).to(qkv.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).flatten(-2).to(qkv.dtype)


def plain_chronos_attention_bwd(
    qkv: torch.Tensor, seg: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
    need_dbias: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the B4b kernels (JAX ``_bwd_kernel``).

    Recomputes W in fp32 and keeps it unrounded: dV = W^T g, dW = g V^T,
    dL = W * (dW - rowsum(dW * W)), dQ = dL K, dK = dL^T Q, and
    dbias = dL summed over the batch.

    Args:
        qkv, seg, bias: as for :func:`plain_chronos_attention`.
        g: (B, S, H*D) output cotangent.
        need_dbias: compute the bias gradient.

    Returns:
        (dqkv (B, S, 3*H*D) in qkv's dtype, column blocks dq|dk|dv;
        dbias (H, S, S) fp32, or None without ``need_dbias``).
    """
    heads, dim = _geometry(qkv, bias)
    q, k, v = split_heads(qkv, heads, dim)
    w = _weights(qkv, seg, bias)
    g32 = g.unflatten(-1, (heads, dim)).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", w, g32)
    dw = torch.einsum("bqhd,bkhd->bhqk", g32, v.float())
    dl = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, q.float())
    dqkv = torch.cat([d.flatten(-2) for d in (dq, dk, dv)], dim=-1).to(qkv.dtype)
    return dqkv, (dl.sum(dim=0) if need_dbias else None)


def fused_chronos_attention(qkv: torch.Tensor, seg: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """softmax(QK^T + bias + segment mask) V over the raw (B, S, 3*H*D) qkv, differentiable.

    Args:
        qkv: (B, S, 3*H*D) contiguous, queries unscaled.
        seg: (B, S) int32 attention-group ids; every token must share its id
            with itself only or with others of its group (padded tokens: an
            id of their own).
        bias: (H, S, S) fp32 relative-position bias; differentiable.

    Returns:
        (B, S, H*D) in qkv's dtype. ``fused_chronos_attention.launches``
        counts forward kernel launches, and ``.shapes`` counts them by
        (dtype, B, S, H, D), from which ``ops._kernels.chronos_plan`` gives the
        route each took (route 4: "persistent").
    """
    return _chronos_op(qkv, seg, bias)


fused_chronos_attention.launches = 0
fused_chronos_attention.shapes = collections.Counter()


def fused_chronos_attention_bwd(
    qkv: torch.Tensor, seg: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
    need_dbias: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Backward of :func:`fused_chronos_attention`: (dqkv, dbias or None), new tensors.

    A CPU tensor runs :func:`plain_chronos_attention_bwd`; any other launches
    the backward kernels or raises. Without ``need_dbias`` neither the
    partial sums nor the reduction of the bias gradient run.
    ``fused_chronos_attention_bwd.launches`` counts kernel launches, ``.shapes``
    counts them by (dtype, B, S, H, D).
    """
    if qkv.device.type == "cpu":
        return plain_chronos_attention_bwd(qkv, seg, bias, g, need_dbias)
    heads, dim = _geometry(qkv, bias)
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    dbias = torch.empty_like(bias) if need_dbias else None
    _kernels.chronos_attention_bwd(qkv, seg, bias, g.contiguous(), dqkv, dbias, heads, dim)
    fused_chronos_attention_bwd.launches += 1
    fused_chronos_attention_bwd.shapes[(qkv.dtype, *qkv.shape[:2], heads, dim)] += 1
    return dqkv, dbias


fused_chronos_attention_bwd.launches = 0
fused_chronos_attention_bwd.shapes = collections.Counter()


def _forward(qkv: torch.Tensor, seg: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The op's implementation: plain on a CPU tensor, else the kernel, counted."""
    if qkv.device.type == "cpu":
        return plain_chronos_attention(qkv, seg, bias).contiguous()
    heads, dim = _geometry(qkv, bias)
    out = torch.empty((*qkv.shape[:2], heads * dim), dtype=qkv.dtype, device=qkv.device)
    _kernels.chronos_attention_fwd(qkv, seg, bias, out, heads, dim)
    fused_chronos_attention.launches += 1
    fused_chronos_attention.shapes[(qkv.dtype, *qkv.shape[:2], heads, dim)] += 1
    return out


def _setup_context(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
    qkv, seg, bias = ctx.saved_tensors
    dqkv, dbias = fused_chronos_attention_bwd(qkv, seg, bias, g, ctx.needs_input_grad[2])
    return dqkv, None, dbias


def _fake(qkv: torch.Tensor, seg: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The shape and dtype for ``torch.export``; a real meta tensor takes the kernel path."""
    if not is_traced(qkv):
        return _forward(qkv, seg, bias)
    return qkv.new_empty((*qkv.shape[:2], qkv.shape[-1] // 3))


# The custom op mtt::fused_chronos_attention, registered as ops/attention.py's
# entry points are: one implementation for every device, a fake one for
# torch.export (and meta tensors), the backward kernels through register_autograd.
_chronos_op = torch.library.custom_op("mtt::fused_chronos_attention", _forward, mutates_args=())
_chronos_op.register_fake(_fake)
_chronos_op.register_autograd(_backward, setup_context=_setup_context)


def _vmap_rule(info, in_dims, qkv, seg, bias):
    """Under ``torch.func.vmap`` (a trial axis): qkv and seg with the trial axis folded
    into the batch rows. A shared (H, S, S) bias (the frozen encoder of a multimodal
    sweep) makes that one launch, and one backward launch, for all trials. A bias
    batched over the trials (a baseline sweep trains the bucket table per trial) cannot
    share a launch, since the kernel takes one bias: the op then launches once per
    trial, on that trial's rows and bias, and the outputs are stacked."""
    trials = info.batch_size
    qkv = fold_trials(qkv, in_dims[0], trials).contiguous()
    seg = fold_trials(seg, in_dims[1], trials).contiguous()
    if in_dims[2] is None:
        return _chronos_op(qkv, seg, bias).unflatten(0, (trials, -1)), 0
    bias = bias.movedim(in_dims[2], 0)
    rows = qkv.shape[0] // trials
    outs = [
        _chronos_op(qkv[t * rows : (t + 1) * rows], seg[t * rows : (t + 1) * rows], bias[t].contiguous())
        for t in range(trials)
    ]
    return torch.stack(outs), 0


_chronos_op.register_vmap(_vmap_rule)
