"""The port's kernels and autograd Functions under ``torch.func.vmap``: the trial axis of a
vectorized sweep.

Each custom op (B1-B4) under ``vmap`` inside ``ops.attention.kernel_route`` (so CPU
tensors go through the ops and their vmap rules) against a loop of per-trial calls,
forward and ``torch.autograd.grad``: bit-equal, since every kernel's rows are
independent and the rule only folds the trial axis into the batch rows; a gradient of
an operand shared by the trials (B4's bias, a shared dense weight) is one sum over all
rows against a sum of per-trial sums, so it is held to 1e-6 relative instead. On meta
tensors (which take the kernel path; the launch functions are replaced, so nothing
runs) a vmapped call is one launch each way for all trials. PyTorch's per-sample
fallback is disabled in every test here, so an op without a vmap rule raises.

``_DenseBf16``, ``_Swish`` and ``_SoftmaxLowp`` under ``vmap`` against eager, and their
eager results and gradients against the forms they had before they gained a
``setup_context`` and a vmap rule (copied below): bit-equal.
"""

import numpy as np
import pytest
import torch
from torch.func import functional_call, vmap

from multimodal_timesfm_torch.models import layers as tl
from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops import attention as tattn
from multimodal_timesfm_torch.ops import chronos_attention as tchronos
from multimodal_timesfm_torch.ops import qkv_attention as tqkv

pytestmark = pytest.mark.filterwarnings("error")


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    """PyTorch's per-sample fallback (an op without a batching rule) raises instead of
    warning: its warning comes from C++ and does not reach Python's filters."""
    torch._C._functorch._set_vmap_fallback_enabled(False)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(True)

T, B, S, H, D = 3, 2, 8, 2, 4


def _rand(*shape, dtype=torch.float32, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(dtype)


def _loop_and_vmap(fn, args, in_dims, grad_idx):
    """(vmapped out, its grads, stacked per-trial outs, their grads) of sum(out^2)."""
    out = vmap(fn, in_dims=in_dims)(*args)
    grads = torch.autograd.grad(out.float().square().sum(), [args[i] for i in grad_idx])
    refs = [fn(*[a if d is None else a.select(d, t) for a, d in zip(args, in_dims)]) for t in range(T)]
    ref_grads = torch.autograd.grad(sum(r.float().square().sum() for r in refs), [args[i] for i in grad_idx])
    return out, grads, torch.stack(refs), ref_grads


def _valid(seed, batched=True):
    valid = torch.from_numpy(np.random.default_rng(seed).random((T, B, S) if batched else (B, S)) > 0.3)
    valid[..., 0] = True
    return valid


def _b1(qkv, valid):
    return tqkv.fused_qkv_causal_attention(qkv, valid, H, D)


def _b2(qkv, valid):
    return tattn.fused_causal_attention(*tqkv.split_heads(qkv, H, D), valid)


def _b3(qkv, valid):
    return tattn.flash_causal_attention(*tqkv.split_heads(qkv, H, D), valid)


@pytest.mark.parametrize("shared_mask", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", [_b1, _b2, _b3], ids=["B1", "B2", "B3"])
def test_causal_ops_under_vmap_match_per_trial_calls(entry, dtype, shared_mask):
    """The trial axis at dim 1 of qkv (a non-leading vmap dimension), the mask per trial
    or shared: outputs and dqkv bit-equal to per-trial calls."""
    qkv = _rand(B, T, S, 3 * H * D, dtype=dtype).requires_grad_()
    valid = _valid(1, batched=not shared_mask)
    with tattn.kernel_route():
        out, grads, ref, ref_grads = _loop_and_vmap(
            entry, (qkv, valid), (1, None if shared_mask else 0), (0,)
        )
    assert torch.equal(out, ref)
    assert torch.equal(grads[0], ref_grads[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_per_trial", [False, True])
def test_chronos_op_under_vmap_matches_per_trial_calls(bias_per_trial, dtype):
    """B4 with segment ids per trial and the (H, S, S) bias shared (a multimodal sweep's
    frozen encoder) or per trial (a baseline sweep): outputs and dqkv bit-equal; the bias
    gradient bit-equal when per trial, within 1e-6 relative of the sum of per-trial sums
    when shared (one reduction over all rows)."""
    qkv = _rand(T, B, S, 3 * H * D, dtype=dtype).requires_grad_()
    seg = torch.from_numpy(np.random.default_rng(2).integers(0, 2, (T, B, S)).astype(np.int32))
    bias = _rand(*((T,) if bias_per_trial else ()), H, S, S, seed=3).requires_grad_()
    with tattn.kernel_route():
        out, grads, ref, ref_grads = _loop_and_vmap(
            tchronos.fused_chronos_attention, (qkv, seg, bias), (0, 0, 0 if bias_per_trial else None), (0, 2)
        )
    assert torch.equal(out, ref)
    assert torch.equal(grads[0], ref_grads[0])
    if bias_per_trial:
        assert torch.equal(grads[1], ref_grads[1])
    else:
        np.testing.assert_allclose(grads[1].numpy(), ref_grads[1].numpy(), rtol=1e-6, atol=1e-6)


def _launch_counters():
    return [tqkv.fused_qkv_causal_attention, tqkv.fused_qkv_causal_attention_bwd,
            tattn.fused_causal_attention, tattn.fused_causal_attention_bwd,
            tchronos.fused_chronos_attention, tchronos.fused_chronos_attention_bwd]


@pytest.fixture
def meta_kernels(monkeypatch):
    """The launch functions replaced (meta tensors take the kernel path); the plain
    attention made to raise; the launch counters read as a difference."""
    for name in ("attention_fwd", "attention_bwd", "chronos_attention_fwd", "chronos_attention_bwd"):
        monkeypatch.setattr(_kernels, name, lambda *a: None)

    def no_plain(*a):
        raise AssertionError("the plain attention ran on the kernel route")

    monkeypatch.setattr(tl, "plain_causal_attention", no_plain)
    before = [c.launches for c in _launch_counters()]
    return lambda: [c.launches - b for c, b in zip(_launch_counters(), before)]


@pytest.mark.parametrize("seq,want", [(16, [2, 2, 0, 0, 0, 0]), (12, [0, 0, 2, 2, 0, 0])])
def test_vmapped_stack_launches_once_per_layer_for_all_trials(meta_kernels, seq, want):
    """A two-layer TimesFM stack, its weights per trial (baseline mode) through
    ``functional_call`` under ``vmap``, forward and backward on meta tensors: two forward
    and two backward launches of B1 (S = 16) or B2 (S = 12) for T trials, not 2T; the
    plain path never runs and nothing falls back to a per-sample loop."""
    stack = tl.StackedTransformer(2, 16, 2, 8, 16, torch.Generator().manual_seed(0)).to("meta")
    params = {k: v.detach().expand(T, *v.shape).clone().requires_grad_() for k, v in stack.named_parameters()}
    x = torch.empty(T, B, seq, 16, device="meta")
    pad = torch.zeros(T, B, seq, dtype=torch.bool, device="meta")
    out = vmap(lambda p, xi, pi: functional_call(stack, p, (xi, pi)))(params, x, pad)
    torch.autograd.grad(out.sum(), list(params.values()))
    assert meta_kernels() == want


def test_vmapped_chronos_encoder_launches_once_per_layer(meta_kernels):
    """A two-layer Chronos-2 encoder shared by the trials (a multimodal sweep), inputs per
    trial, on meta tensors: B4f and B4b once per layer for all T trials."""
    from multimodal_timesfm_torch.models.chronos import Chronos2Config, ChronosEncoder

    encoder = ChronosEncoder(Chronos2Config.tiny(), torch.Generator().manual_seed(0)).to("meta").requires_grad_(False)
    x = torch.empty(T, B, 10, 32, device="meta", requires_grad=True)
    mask = torch.ones(T, B, 10, dtype=torch.int32, device="meta")
    out = vmap(encoder)(x, mask)
    torch.autograd.grad(out.sum(), x)
    assert meta_kernels() == [0, 0, 0, 0, 2, 2]


def test_a_custom_op_without_a_vmap_rule_would_fail():
    """The guard these tests rely on: with the fallback disabled, a custom op that has no
    vmap rule raises instead of running per sample."""
    def double(x: torch.Tensor) -> torch.Tensor:
        return x * 2

    op = torch.library.custom_op("mtt_test::no_rule", double, mutates_args=())
    with pytest.raises(RuntimeError, match="vmap fallback"):
        vmap(op)(torch.ones(T, 2))


# ---------------------------------------------------------------------------
# the three autograd Functions
# ---------------------------------------------------------------------------


class _OldDenseBf16(torch.autograd.Function):
    """``_DenseBf16`` as it was before it gained ``setup_context`` and a vmap rule."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        x2 = x.reshape(-1, x.shape[-1])
        y = tl._mm32(x2, weight.t())
        if bias is not None:
            y = y + bias.float()
        ctx.save_for_backward(x2, weight)
        ctx.x_shape = x.shape
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y.to(x.dtype).reshape(*x.shape[:-1], weight.shape[0])

    @staticmethod
    def backward(ctx, g):
        x2, weight = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = tl._mm32(g2, weight).to(x2.dtype).reshape(ctx.x_shape)
        if ctx.needs_input_grad[1]:
            dw = tl._mm32(g2.t(), x2).to(weight.dtype)
        if ctx.needs_input_grad[2]:
            db = g2.float().sum(dim=0).to(ctx.bias_dtype)
        return dx, dw, db


class _OldSwish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


class _OldSoftmaxLowp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, dtype):
        weights = torch.softmax(logits, dim=-1).to(dtype)
        ctx.save_for_backward(weights)
        return weights

    @staticmethod
    def backward(ctx, g):
        (weights,) = ctx.saved_tensors
        w32, g32 = weights.float(), g.float()
        return w32 * (g32 - (g32 * w32).sum(dim=-1, keepdim=True)), None


def _out_and_grads(fn, args, grad_idx):
    out = fn(*args)
    return out, torch.autograd.grad(out.float().square().sum(), [args[i] for i in grad_idx])


def test_functions_in_eager_mode_are_bit_equal_to_their_previous_forms():
    """Outputs and gradients of the three Functions against the forms before the rewrite."""
    x = _rand(5, 3, 8, dtype=torch.bfloat16).requires_grad_()
    w = _rand(6, 8, dtype=torch.bfloat16, seed=1).requires_grad_()
    b = _rand(6, seed=2).requires_grad_()
    logits = (_rand(4, 7, seed=3) * 4).requires_grad_()
    for new, old, args, grad_idx in (
        (tl.dense, _OldDenseBf16.apply, (x, w, b), (0, 1, 2)),
        (tl.swish, _OldSwish.apply, (x,), (0,)),
        (tl.swish, _OldSwish.apply, (_rand(64, seed=4).requires_grad_(),), (0,)),
        (lambda z: tattn.softmax_lowp(z, torch.bfloat16), lambda z: _OldSoftmaxLowp.apply(z, torch.bfloat16),
         (logits,), (0,)),
    ):
        out, grads = _out_and_grads(new, args, grad_idx)
        ref, ref_grads = _out_and_grads(old, args, grad_idx)
        assert torch.equal(out, ref)
        assert all(torch.equal(g, r) for g, r in zip(grads, ref_grads))


@pytest.mark.parametrize("weight_per_trial", [False, True])
def test_dense_bf16_under_vmap_matches_eager(weight_per_trial):
    """``dense`` of bf16 x and a bf16 weight under ``vmap``: a shared weight folds the
    trials into the GEMM's rows, per-trial weights run one batched GEMM. Output, dx (and
    dW, db for per-trial weights) bit-equal to per-trial calls; a shared weight's dW and
    db are one sum over all rows: dW within one bf16 rounding of the fp32 sum, db within
    1e-6 relative of the loop's."""
    x = _rand(T, B, S, 8, dtype=torch.bfloat16).requires_grad_()
    w = _rand(*((T,) if weight_per_trial else ()), 6, 8, dtype=torch.bfloat16, seed=1).requires_grad_()
    b = _rand(*((T,) if weight_per_trial else ()), 6, seed=2).requires_grad_()
    dims = (0, 0 if weight_per_trial else None, 0 if weight_per_trial else None)
    out, grads, ref, ref_grads = _loop_and_vmap(tl.dense, (x, w, b), dims, (0, 1, 2))
    assert torch.equal(out, ref)
    assert torch.equal(grads[0], ref_grads[0])
    if weight_per_trial:
        assert torch.equal(grads[1], ref_grads[1]) and torch.equal(grads[2], ref_grads[2])
    else:
        # The fp32 sum over every trial's rows, rounded once: the loop instead rounds each
        # trial's dW to bf16 before autograd adds them.
        g = (2 * out.detach().float()).to(torch.bfloat16)
        dw32 = sum(tl._mm32(g[t].reshape(-1, 6).t(), x[t].detach().reshape(-1, 8)) for t in range(T))
        np.testing.assert_allclose(grads[1].float().numpy(), dw32.numpy(), rtol=2 ** -8, atol=1e-6)
        np.testing.assert_allclose(grads[2].numpy(), ref_grads[2].numpy(), rtol=1e-6)


@pytest.mark.parametrize("in_dim", [0, 2])
def test_swish_and_softmax_lowp_under_vmap_match_eager(in_dim):
    """Elementwise swish and the low-precision softmax with the trial axis at dim 0 or 2:
    outputs and gradients bit-equal to per-trial calls."""
    x = _rand(4, 5, T, 6, dtype=torch.bfloat16).movedim(2, in_dim).contiguous().requires_grad_()
    out, grads, ref, ref_grads = _loop_and_vmap(tl.swish, (x,), (in_dim,), (0,))
    assert torch.equal(out, ref) and torch.equal(grads[0], ref_grads[0])
    logits = (x.detach().float() * 3).requires_grad_()
    out, grads, ref, ref_grads = _loop_and_vmap(
        lambda z: tattn.softmax_lowp(z, torch.bfloat16), (logits,), (in_dim,), (0,)
    )
    assert torch.equal(out, ref) and torch.equal(grads[0], ref_grads[0])
