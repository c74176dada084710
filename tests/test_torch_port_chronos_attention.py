"""PyTorch port vs the JAX package: Chronos-2's T5 attention (B4) and the flash entry point (B3).

The JAX side runs its Pallas kernels in interpret mode on the CPU, as its own
tests do (``tests/test_chronos_attention.py``, ``tests/test_attention.py``).
Inputs are drawn with numpy from a seed. The Chronos cases follow JAX's
segment-id contract: ids unique per (row, segment), every padded token an id
of its own, so every token keeps at least its own key and the kernel and its
plain version agree on every row. The flash cases compare valid query rows
only, which is the contract of JAX's flash kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multimodal_timesfm_tpu.ops.attention import flash_causal_attention as j_flash
from multimodal_timesfm_tpu.ops.chronos_attention import fused_chronos_attention as j_chronos
from multimodal_timesfm_tpu.ops.chronos_attention import make_rowtile_bias
from multimodal_timesfm_torch.models import layers as tl
from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops import attention as tattn
from multimodal_timesfm_torch.ops import chronos_attention as tca

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Forward and dqkv. fp32: the same fp32 sums in another order. bf16: both round
# the same fp32 accumulators once, so they may land one bf16 ulp apart.
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=1e-2)}
# JAX's own bound for the kernel's gradients against its oracle
# (tests/test_chronos_attention.py): dbias sums dL over the batch, and the
# tile VJP sums JAX's block-diagonal cotangent once more.
GRAD_TOL = dict(atol=2e-4, rtol=1e-4)

# (batch, seq, heads, dim, segments): the five shapes of JAX's kernel tests.
SHAPES = [(4, 16, 3, 8, 1), (4, 16, 3, 8, 2), (2, 8, 2, 8, 1), (3, 24, 4, 16, 3), (6, 72, 2, 8, 1)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _chronos_case(batch, seq, heads, dim, segments, seed=0):
    """qkv, seg and bias as JAX's tests draw them (tests/test_chronos_attention.py)."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(batch, seq, 3 * heads * dim)).astype(np.float32)
    base = np.repeat(np.arange(segments), -(-seq // segments))[:seq]
    valid = rng.random((batch, seq)) > 0.2
    valid[:, 0] = True
    row = np.arange(batch)[:, None]
    tok = row * seq + np.arange(seq)[None, :]
    seg = np.where(valid, base[None] + row * (seq + 1), -1 - tok).astype(np.int32)
    bias = rng.normal(size=(heads, seq, seq)).astype(np.float32)
    g = rng.normal(size=(batch, seq, heads * dim)).astype(np.float32)
    return qkv, seg, bias, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,seq,heads,dim,segments", SHAPES)
def test_plain_forward_matches_jax_kernel(batch, seq, heads, dim, segments, dtype):
    qkv, seg, bias, _ = _chronos_case(batch, seq, heads, dim, segments)
    ref = j_chronos(
        jnp.asarray(qkv, JDT[dtype]), jnp.asarray(seg),
        make_rowtile_bias(jnp.asarray(bias), batch, seq), heads, dim, True,
    )
    out = tca.plain_chronos_attention(
        torch.from_numpy(qkv).to(TDT[dtype]), torch.from_numpy(seg), torch.from_numpy(bias)
    )
    assert out.dtype == TDT[dtype] and out.shape == (batch, seq, heads * dim)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,seq,heads,dim,segments", [SHAPES[1], SHAPES[3], SHAPES[4]])
def test_plain_backward_matches_jax_kernel_vjp(batch, seq, heads, dim, segments, dtype):
    """dqkv and dbias against jax.vjp of the interpret-mode kernel; the VJP of JAX's
    bias tiling reduces its block-diagonal cotangent to (H, S, S)."""
    qkv, seg, bias, g = _chronos_case(batch, seq, heads, dim, segments, seed=2)
    _, vjp = jax.vjp(
        lambda t, b: j_chronos(t, jnp.asarray(seg), make_rowtile_bias(b, batch, seq), heads, dim, True),
        jnp.asarray(qkv, JDT[dtype]), jnp.asarray(bias),
    )
    ref_dqkv, ref_dbias = vjp(jnp.asarray(g, JDT[dtype]))
    dqkv, dbias = tca.plain_chronos_attention_bwd(
        torch.from_numpy(qkv).to(TDT[dtype]), torch.from_numpy(seg), torch.from_numpy(bias),
        torch.from_numpy(g).to(TDT[dtype]),
    )
    assert dqkv.dtype == TDT[dtype] and dbias.dtype == torch.float32
    assert dbias.shape == (heads, seq, seq)
    np.testing.assert_allclose(_np(dqkv), _np(ref_dqkv), **(GRAD_TOL if dtype == "float32" else TOL[dtype]))
    np.testing.assert_allclose(_np(dbias), _np(ref_dbias), **GRAD_TOL)


# Chronos-2's own token counts at its head_dim 64: 67 (context 32: one segment, padded
# tokens with ids of their own), 80 (16 packed rows of 5 tokens, the mop2 fine-tune) and
# 97 (context 512). They cover the kernels' fitted tiles (one 80-row tile, exactly one
# tile, one 112-row tile) and JAX's kernel packs two batch rows per program at each.
CHRONOS2_SHAPES = [(2, 67, 2, 64, 1), (2, 80, 2, 64, 16), (2, 97, 2, 64, 1)]


def _chronos2_case(batch, seq, heads, dim, segments, seed):
    """As :func:`_chronos_case`, with q, k and v scaled by dim^-1/4 so that the logits
    q.k are O(1) at head_dim 64, as the encoder's weights keep them."""
    qkv, seg, bias, g = _chronos_case(batch, seq, heads, dim, segments, seed=seed)
    return (qkv / dim ** 0.25).astype(np.float32), seg, bias, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,seq,heads,dim,segments", CHRONOS2_SHAPES)
def test_plain_forward_matches_jax_kernel_at_chronos2_token_counts(batch, seq, heads, dim, segments, dtype):
    qkv, seg, bias, _ = _chronos2_case(batch, seq, heads, dim, segments, seed=11)
    ref = j_chronos(
        jnp.asarray(qkv, JDT[dtype]), jnp.asarray(seg),
        make_rowtile_bias(jnp.asarray(bias), batch, seq), heads, dim, True,
    )
    out = tca.plain_chronos_attention(
        torch.from_numpy(qkv).to(TDT[dtype]), torch.from_numpy(seg), torch.from_numpy(bias)
    )
    assert out.dtype == TDT[dtype] and out.shape == (batch, seq, heads * dim)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,seq,heads,dim,segments", CHRONOS2_SHAPES)
def test_plain_backward_matches_jax_kernel_vjp_at_chronos2_token_counts(
    batch, seq, heads, dim, segments, dtype
):
    """dqkv and dbias against jax.vjp of the interpret-mode kernel at Chronos-2's shapes."""
    qkv, seg, bias, g = _chronos2_case(batch, seq, heads, dim, segments, seed=12)
    _, vjp = jax.vjp(
        lambda t, b: j_chronos(t, jnp.asarray(seg), make_rowtile_bias(b, batch, seq), heads, dim, True),
        jnp.asarray(qkv, JDT[dtype]), jnp.asarray(bias),
    )
    ref_dqkv, ref_dbias = vjp(jnp.asarray(g, JDT[dtype]))
    dqkv, dbias = tca.plain_chronos_attention_bwd(
        torch.from_numpy(qkv).to(TDT[dtype]), torch.from_numpy(seg), torch.from_numpy(bias),
        torch.from_numpy(g).to(TDT[dtype]),
    )
    assert dqkv.dtype == TDT[dtype] and dbias.shape == (heads, seq, seq)
    np.testing.assert_allclose(_np(dqkv), _np(ref_dqkv), **(GRAD_TOL if dtype == "float32" else TOL[dtype]))
    np.testing.assert_allclose(_np(dbias), _np(ref_dbias), **GRAD_TOL)


def test_function_backward_is_the_kernel_math_and_skips_a_frozen_bias():
    """On the CPU the Function's backward is plain_chronos_attention_bwd: in fp32 it equals
    autograd through the plain forward; a bias that needs no gradient gets none."""
    qkv, seg, bias, g = _chronos_case(3, 24, 4, 16, 3, seed=4)
    t_seg, t_g = torch.from_numpy(seg), torch.from_numpy(g)
    a, b = (torch.from_numpy(qkv).requires_grad_(), torch.from_numpy(bias).requires_grad_())
    out = tca.fused_chronos_attention(a, t_seg, b)
    assert len(out.grad_fn.saved_tensors) == 3  # qkv, seg and bias, as JAX's residuals
    out.backward(t_g)
    a2, b2 = (torch.from_numpy(qkv).requires_grad_(), torch.from_numpy(bias).requires_grad_())
    tca.plain_chronos_attention(a2, t_seg, b2).backward(t_g)
    # The same fp32 sums in another order, over gradients up to ~20 (measured 1.9e-6).
    torch.testing.assert_close(a.grad, a2.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b.grad, b2.grad, rtol=1e-5, atol=1e-5)
    frozen = torch.from_numpy(bias)
    a3 = torch.from_numpy(qkv).requires_grad_()
    tca.fused_chronos_attention(a3, t_seg, frozen).backward(t_g)
    assert frozen.grad is None
    torch.testing.assert_close(a3.grad, a.grad, rtol=0, atol=0)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("bias_trains", [True, False])
def test_kernel_route_is_differentiable(monkeypatch, bias_trains):
    """A tensor that is not on the CPU takes the kernels forward AND backward: the output
    carries a grad_fn, the backward reaches B4b's wrapper once, and a bias that needs no
    gradient is given no dbias buffer. (Meta tensors stand in for CUDA ones; the launches
    are recorded, not run.)"""
    calls = []
    monkeypatch.setattr(_kernels, "chronos_attention_fwd", lambda *a: calls.append(("fwd",)))
    monkeypatch.setattr(_kernels, "chronos_attention_bwd", lambda *a: calls.append(("bwd", a[5] is None)))
    before = (tca.fused_chronos_attention.launches, tca.fused_chronos_attention_bwd.launches)
    qkv = _meta(2, 67, 3 * 12 * 64).requires_grad_()
    bias = _meta(12, 67, 67).requires_grad_(bias_trains)
    out = tca.fused_chronos_attention(qkv, _meta(2, 67, dtype=torch.int32), bias)
    assert out.shape == (2, 67, 768) and out.grad_fn is not None
    out.backward(_meta(2, 67, 768))
    assert qkv.grad.shape == qkv.shape
    assert (bias.grad is not None) == bias_trains
    assert calls == [("fwd",), ("bwd", not bias_trains)]
    after = (tca.fused_chronos_attention.launches, tca.fused_chronos_attention_bwd.launches)
    assert [x - y for x, y in zip(after, before)] == [1, 1]


@pytest.mark.parametrize("entry", ["forward", "backward"])
def test_kernel_path_raises_without_nvcc(monkeypatch, tmp_path, entry):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "nvcc_path", no_nvcc)
    _kernels.library.cache_clear()
    args = (_meta(2, 16, 48), _meta(2, 16, dtype=torch.int32), _meta(2, 16, 16))
    fn = tca.fused_chronos_attention if entry == "forward" else tca.fused_chronos_attention_bwd
    if entry == "backward":
        args = (*args, _meta(2, 16, 16))
    counter = tca.fused_chronos_attention if entry == "forward" else fn
    before = counter.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fn(*args)
    assert counter.launches == before


def test_flash_forward_matches_jax_flash_on_valid_rows():
    """tests/test_attention.py:80's case: B=2 S=256 H=2 D=128, one left-padded row."""
    rng = np.random.default_rng(7)
    batch, seq, heads, dim = 2, 256, 2, 128
    q = (rng.normal(size=(batch, seq, heads, dim)) * 0.1).astype(np.float32)
    k, v = (rng.normal(size=(batch, seq, heads, dim)).astype(np.float32) for _ in range(2))
    valid = np.ones((batch, seq), bool)
    valid[1, :64] = False
    ref = j_flash(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(valid), interpret=True)
    out = tattn.flash_causal_attention(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(valid))
    rows = valid[:, :, None, None]
    np.testing.assert_allclose(_np(out) * rows, _np(ref) * rows, atol=2e-5)


def test_flash_gradients_match_jax_flash():
    """tests/test_attention.py:104's case: B=1 S=128 H=2 D=128, loss sum(out^2)."""
    rng = np.random.default_rng(9)
    batch, seq, heads, dim = 1, 128, 2, 128
    q = (rng.normal(size=(batch, seq, heads, dim)) * 0.1).astype(np.float32)
    k, v = (rng.normal(size=(batch, seq, heads, dim)).astype(np.float32) for _ in range(2))
    valid = np.ones((batch, seq), bool)
    with pltpu.force_tpu_interpret_mode():
        refs = jax.grad(
            lambda *a: jnp.sum(j_flash(*a, jnp.asarray(valid)) ** 2), argnums=(0, 1, 2)
        )(*(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = tattn.flash_causal_attention_bwd.launches
    (tattn.flash_causal_attention(*ts, torch.from_numpy(valid)) ** 2).sum().backward()
    assert tattn.flash_causal_attention_bwd.launches == before  # CPU: the plain version
    for t, ref in zip(ts, refs):
        np.testing.assert_allclose(_np(t.grad), _np(ref), atol=5e-4)


def test_attention_routes_past_2048_tokens_to_the_flash_entry_point(monkeypatch):
    """Where ``needs_flash`` holds (CUDA, S > 2048), Attention calls flash_causal_attention."""
    seen = []

    def flash(q, k, v, key_valid):
        seen.append(q.shape)
        return tattn.plain_causal_attention(q, k, v, key_valid)

    monkeypatch.setattr(tl, "needs_flash", lambda x, seq, dim: seq > 2048)
    monkeypatch.setattr(tl, "flash_causal_attention", flash)
    attn = tl.Attention(8, 2, 4, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 2100, 8)).astype(np.float32))
    with torch.inference_mode():
        out = attn(x, torch.zeros(1, 2100, dtype=torch.bool))
    assert seen == [(1, 2100, 2, 4)] and out.shape == (1, 2100, 8)
