"""Causal attention with key padding: the plain path, the whole-sequence and the flash entry points.

Counterpart of ``multimodal_timesfm_tpu/ops/attention.py``. Layout (B, S, H, D)
with q pre-scaled and ``key_valid`` (B, S) bool, True = valid key. Masked
logits are ``finfo(float32).min``, never ``-inf``: a query row with no valid
key then gets uniform weights and stays finite.

``fused_causal_attention`` (B2, S <= 2048 where B1 does not run) and
``flash_causal_attention`` (B3, S > 2048) are differentiable ``torch.library``
custom ops (``torch.ops.mtt.*``), so ``torch.export`` keeps them in its
graph. On a CUDA tensor their forwards launch the hand-written kernel
``csrc/attention_fwd.cu`` and their backwards ``csrc/attention_bwd.cu``; on a
CPU tensor each runs its plain version. There is no other fallback. Both
kernels walk the keys and the query rows in shared-memory tiles and keep no
(S, S) buffer, so one pair of kernels serves both lengths, each entry point
with its own launch counters. As in JAX's custom VJP, the only residuals are
q, k, v and the mask: the backward recomputes the weights.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars

import torch
from torch._subclasses.fake_tensor import FakeTensor

from multimodal_timesfm_torch.ops import _kernels

NEG_INF = torch.finfo(torch.float32).min


class _SoftmaxLowp(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return torch.softmax(logits, dim=-1).to(dtype)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor, None]:
        (weights,) = ctx.saved_tensors
        w32, g32 = weights.float(), g.float()
        return w32 * (g32 - (g32 * w32).sum(dim=-1, keepdim=True)), None


def softmax_lowp(logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 softmax over the last axis, returned and saved in ``dtype`` (JAX ``softmax_lowp``).

    The backward is the softmax rule evaluated from the saved ``dtype``
    weights upcast to fp32, as JAX's custom VJP does; the fp32 weights are
    never kept.
    """
    return _SoftmaxLowp.apply(logits, dtype)


def masked_logits(q: torch.Tensor, k: torch.Tensor, key_valid: torch.Tensor) -> torch.Tensor:
    """fp32 (B, H, S, S) logits of q pre-scaled, causal-future and padded keys at finfo.min."""
    seq = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    causal = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    mask = causal[None, None] & key_valid[:, None, None, :]
    return logits.masked_fill(~mask, NEG_INF)


def plain_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch attention, the counterpart of JAX ``xla_causal_attention``.

    fp32 logits and softmax; the weights are rounded to the compute dtype
    (:func:`softmax_lowp`) before an fp32-accumulated PV product (products of
    two bf16 values are exact in fp32), and the output is cast once.

    Args:
        q, k, v: (B, S, H, D); q pre-scaled.
        key_valid: (B, S) bool, True = valid key.

    Returns:
        (B, S, H, D) in q's dtype.
    """
    weights = softmax_lowp(masked_logits(q, k, key_valid), q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float()).to(q.dtype)


def plain_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel (JAX ``_attn_bwd_kernel``).

    Recomputes W = softmax(mask(QK^T)) in fp32 and keeps it unrounded, as the
    kernels do (the plain forward's autograd would use the weights rounded to
    the compute dtype instead): dV = W^T g, dW = g V^T,
    dL = W * (dW - rowsum(dW * W)), dQ = dL K, dK = dL^T Q, all in fp32 with
    one cast to q's dtype.

    Args:
        q, k, v, g: (B, S, H, D); key_valid: (B, S) bool.

    Returns:
        (dq, dk, dv), each (B, S, H, D) in q's dtype.
    """
    w = torch.softmax(masked_logits(q, k, key_valid), dim=-1)
    g32 = g.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", w, g32)
    dw = torch.einsum("bqhd,bkhd->bhqk", g32, v.float())
    dl = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def is_traced(x: torch.Tensor) -> bool:
    """Whether ``x`` is a tensor ``torch.export`` traces with (a fake tensor), as against a
    real one (a meta tensor included)."""
    return isinstance(x, FakeTensor)


def _kernel_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor, counter
) -> torch.Tensor:
    """The forward of both entry points: plain on the CPU, else the kernel, counted on ``counter``."""
    if q.device.type == "cpu":
        return plain_causal_attention(q, k, v, key_valid).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _kernels.attention_fwd(q, k, v, key_valid, out)
    counter.launches += 1
    counter.shapes[(q.dtype, *q.shape)] += 1
    return out


def _kernel_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor, g: torch.Tensor,
    counter,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of both entry points: plain on the CPU, else the kernels, counted on ``counter``."""
    if q.device.type == "cpu":
        return plain_attention_bwd(q, k, v, key_valid, g)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    _kernels.attention_bwd(q, k, v, key_valid, g.contiguous(), dq, dk, dv)
    counter.launches += 1
    counter.shapes[(q.dtype, *q.shape)] += 1
    return dq, dk, dv


def fused_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor
) -> torch.Tensor:
    """Whole-sequence causal attention (JAX ``fused_causal_attention``), differentiable.

    q, k, v: (B, S, H, D) sharing one row stride, each head's D values
    contiguous (so q/k/v column views of a fused projection go in without a
    copy); key_valid: (B, S) bool. Returns a new contiguous (B, S, H, D).
    ``fused_causal_attention.launches`` counts forward kernel launches, ``.shapes`` counts
    them by (dtype, B, S, H, D), from which ``ops._kernels.attention_route_number`` gives the
    route each took. It is the custom op ``torch.ops.mtt.fused_causal_attention``.
    """
    return _fused_op(q, k, v, key_valid)


fused_causal_attention.launches = 0
fused_causal_attention.shapes = collections.Counter()


def fused_causal_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`fused_causal_attention`: (dq, dk, dv), each a new (B, S, H, D).

    A CPU tensor runs :func:`plain_attention_bwd`; any other launches the
    backward kernel or raises. ``fused_causal_attention_bwd.launches`` counts
    kernel launches, ``.shapes`` counts them by (dtype, B, S, H, D).
    """
    return _kernel_bwd(q, k, v, key_valid, g, fused_causal_attention_bwd)


fused_causal_attention_bwd.launches = 0
fused_causal_attention_bwd.shapes = collections.Counter()


def flash_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor
) -> torch.Tensor:
    """Causal attention past 2,048 tokens (JAX ``flash_causal_attention``), differentiable.

    The same function and layout as :func:`fused_causal_attention`, q
    pre-scaled. JAX pads S to a multiple of 128 for its TPU flash kernel's
    tiles and slices the output back; the CUDA kernels take any S, so nothing
    is padded here. As in JAX, the valid query rows are the contract (a row
    with no valid key gets uniform weights here). Returns a new contiguous
    (B, S, H, D); ``flash_causal_attention.launches`` counts forward kernel
    launches, ``.shapes`` counts them by (dtype, B, S, H, D). It is the custom op
    ``torch.ops.mtt.flash_causal_attention``.
    """
    return _flash_op(q, k, v, key_valid)


flash_causal_attention.launches = 0
flash_causal_attention.shapes = collections.Counter()


def flash_causal_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`flash_causal_attention`: (dq, dk, dv), each a new (B, S, H, D).

    A CPU tensor runs :func:`plain_attention_bwd`; any other launches the
    backward kernels or raises. ``flash_causal_attention_bwd.launches``
    counts kernel launches, ``.shapes`` counts them by (dtype, B, S, H, D).
    """
    return _kernel_bwd(q, k, v, key_valid, g, flash_causal_attention_bwd)


flash_causal_attention_bwd.launches = 0
flash_causal_attention_bwd.shapes = collections.Counter()


def trials_first(x: torch.Tensor, dim: int | None, trials: int) -> torch.Tensor:
    """``x`` under a ``torch.func.vmap`` trial axis with its vmap dimension ``dim`` moved
    to the front (an unbatched ``x``, ``dim`` None, expanded to every trial); a view."""
    return x.expand(trials, *x.shape) if dim is None else x.movedim(dim, 0)


def fold_trials(x: torch.Tensor, dim: int | None, trials: int) -> torch.Tensor:
    """:func:`trials_first` folded into the batch rows: (T*B, ...). A view where the
    strides allow it."""
    x = trials_first(x, dim, trials)
    return x.reshape(trials * x.shape[1], *x.shape[2:])


def _register(entry, entry_bwd):
    """Register ``entry`` as the ``torch.library`` custom op ``mtt::<its name>``.

    One implementation serves every device: the plain version on a CPU
    tensor, else the kernel, counted on ``entry.launches`` (so a trace, which
    runs the fake implementation, counts nothing). The fake implementation
    gives ``torch.export`` the output's shape and dtype; PyTorch also runs it
    for meta tensors, and there it takes the kernel path as a CUDA tensor
    does. The backward calls ``entry_bwd``, which launches the backward
    kernel.

    Under ``torch.func.vmap`` (a trial axis, ``training/vectorized.py``) the
    rule folds the trial axis into the batch rows and calls the op once: one
    forward launch and, under autograd outside the vmap, one backward launch
    for all trials. Rows are independent in the kernels, so each trial's rows
    come out as its own call would give them.
    """

    def impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor) -> torch.Tensor:
        return _kernel_fwd(q, k, v, key_valid, entry)

    def fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor) -> torch.Tensor:
        if not is_traced(q):
            return impl(q, k, v, key_valid)
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    op = torch.library.custom_op(f"mtt::{entry.__name__}", impl, mutates_args=())
    op.register_fake(fake)

    def setup_context(ctx, inputs, output) -> None:
        ctx.save_for_backward(*inputs)

    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
        q, k, v, key_valid = ctx.saved_tensors
        return (*entry_bwd(q, k, v, key_valid, g), None)

    op.register_autograd(backward, setup_context=setup_context)

    def vmap_rule(info, in_dims, q, k, v, key_valid):
        trials = info.batch_size
        q, k, v = (fold_trials(x, d, trials) for x, d in zip((q, k, v), in_dims[:3]))
        if len({x.stride(1) for x in (q, k, v)}) > 1:
            # A shared operand was expanded and copied: give all three one row stride.
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = op(q, k, v, fold_trials(key_valid, in_dims[3], trials).contiguous())
        return out.unflatten(0, (trials, -1)), 0

    op.register_vmap(vmap_rule)
    return op


_fused_op = _register(fused_causal_attention, fused_causal_attention_bwd)
_flash_op = _register(flash_causal_attention, flash_causal_attention_bwd)


_ROUTE_CPU_TO_KERNELS = contextvars.ContextVar("route_cpu_to_kernels", default=False)


@contextlib.contextmanager
def kernel_route():
    """Send CPU tensors down the kernel entry points too, inside this block.

    The entry points run their plain versions on a CPU tensor, so the numbers
    do not change; what changes is the graph: ``serving.export_program``
    traces under it, so an artifact exported on the CPU holds the custom ops
    and launches the kernels when it is served on the card.
    """
    token = _ROUTE_CPU_TO_KERNELS.set(True)
    try:
        yield
    finally:
        _ROUTE_CPU_TO_KERNELS.reset(token)


def takes_kernels(x: torch.Tensor) -> bool:
    """Whether ``x`` goes down the kernel entry points: any tensor not on the CPU (a
    meta tensor too), and a CPU one inside :func:`kernel_route`."""
    return x.device.type != "cpu" or _ROUTE_CPU_TO_KERNELS.get()


def supports_fused(x: torch.Tensor, seq: int, dim: int) -> bool:
    """Gate of the whole-sequence entry point (B2): every S from 2 to 2,048 on a tensor
    that :func:`takes_kernels` (the dispatch tries B1 first). The TPU took 256-1,024 with
    S % 8 == 0 here; the CUDA kernels take any S."""
    return takes_kernels(x) and 2 <= seq <= 2048 and dim <= 256


def needs_flash(x: torch.Tensor, seq: int, dim: int) -> bool:
    """Gate of :func:`flash_causal_attention` (B3): S > 2,048, where JAX runs its flash kernel."""
    return takes_kernels(x) and seq > 2048 and dim <= 256
