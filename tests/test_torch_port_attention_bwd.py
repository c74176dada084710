"""PyTorch port vs the JAX package: the attention backward, softmax_lowp and relu VJPs.

The JAX side differentiates its Pallas kernels in interpret mode on the CPU
(``jax.vjp`` of ``fused_qkv_causal_attention(..., True)`` and
``fused_causal_attention(..., True)``), as its own tests do. Inputs are drawn
with numpy from a seed, with left-padded key masks. The output cotangent is
zero on padded query rows: such a row has no valid key, and its weights are
uniform over all S keys in the port but over the packed row tile in JAX's
qkv kernel (ROADMAP queue C); on the model path its cotangent is zero anyway
(the FFN residual is masked and training masks are all False).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.models.layers import relu as j_relu
from multimodal_timesfm_tpu.ops.attention import fused_causal_attention as j_fused
from multimodal_timesfm_tpu.ops.attention import softmax_lowp as j_softmax_lowp
from multimodal_timesfm_tpu.ops.qkv_attention import fused_qkv_causal_attention as j_fused_qkv
from multimodal_timesfm_torch.models.layers import relu
from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops import attention as tattn
from multimodal_timesfm_torch.ops import qkv_attention as tqkv

# fp32: the same fp32 sums in another order (measured <= 2.4e-6). bf16: both
# round the same fp32 accumulators once, so they may land one bf16 ulp apart.
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=1e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _left_padded(rng, batch, seq):
    pads = rng.integers(0, seq // 2, size=batch)
    pads[0] = 0
    return np.arange(seq)[None, :] >= pads[:, None]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv_case(seq, heads, dim, batch=3):
    rng = np.random.default_rng(seq + heads)
    qkv = rng.normal(size=(batch, seq, 3 * heads * dim)).astype(np.float32)
    qkv[..., : heads * dim] /= np.sqrt(dim)
    valid = _left_padded(rng, batch, seq)
    g = (rng.normal(size=(batch, seq, heads * dim)) * valid[..., None]).astype(np.float32)
    return qkv, valid, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq,heads,dim", [(16, 4, 8), (64, 2, 16), (8, 3, 8)])
def test_plain_qkv_bwd_matches_jax_kernel_vjp(seq, heads, dim, dtype):
    qkv, valid, g = _qkv_case(seq, heads, dim)
    _, vjp = jax.vjp(
        lambda t: j_fused_qkv(t, jnp.asarray(valid), heads, dim, True), jnp.asarray(qkv, JDT[dtype])
    )
    (ref,) = vjp(jnp.asarray(g, JDT[dtype]))
    out = tqkv.plain_qkv_attention_bwd(
        torch.from_numpy(qkv).to(TDT[dtype]), torch.from_numpy(valid),
        torch.from_numpy(g).to(TDT[dtype]), heads, dim,
    )
    assert out.dtype == TDT[dtype] and out.shape == qkv.shape
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_whole_sequence_bwd_matches_jax_kernel_vjp(dtype):
    rng = np.random.default_rng(7)
    batch, seq, heads, dim = 2, 256, 2, 8
    q, k, v = (rng.normal(size=(batch, seq, heads, dim)).astype(np.float32) for _ in range(3))
    q /= np.sqrt(dim)
    valid = _left_padded(rng, batch, seq)
    g = (rng.normal(size=(batch, seq, heads, dim)) * valid[..., None, None]).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, b, c: j_fused(a, b, c, jnp.asarray(valid), True),
        *(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)),
    )
    refs = vjp(jnp.asarray(g, JDT[dtype]))
    outs = tattn.plain_attention_bwd(
        *(torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v)), torch.from_numpy(valid),
        torch.from_numpy(g).to(TDT[dtype]),
    )
    for out, ref in zip(outs, refs):
        assert out.dtype == TDT[dtype]
        np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["deep", "holes"])
def test_plain_bwd_matches_jax_kernel_vjp_under_skip_rule_masks(kind, dtype):
    """Masks that exercise the CUDA kernels' skip rule: "deep" left pads in [64, S - 1]
    (whole 64-row query tiles with no valid key), "holes" (random invalid keys after the
    first valid one, and a batch row with no valid key). The cotangent is zero on the rows
    with no valid key, as on the model path."""
    rng = np.random.default_rng(31 if kind == "deep" else 32)
    batch, seq, heads, dim = 3, 256, 2, 8
    q, k, v = (rng.normal(size=(batch, seq, heads, dim)).astype(np.float32) for _ in range(3))
    q /= np.sqrt(dim)
    ar = np.arange(seq)[None, :]
    if kind == "deep":
        pads = rng.integers(64, seq, size=batch)
        pads[0] = seq - 1
        valid = ar >= pads[:, None]
    else:
        valid = _left_padded(rng, batch, seq)
        first = valid.argmax(axis=1)
        valid &= (rng.random((batch, seq)) >= 0.3) | (ar == first[:, None])
        valid[-1] = False
    first = np.where(valid.any(axis=1), valid.argmax(axis=1), seq)
    sees_a_key = ar >= first[:, None]
    g = (rng.normal(size=(batch, seq, heads, dim)) * sees_a_key[..., None, None]).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, b, c: j_fused(a, b, c, jnp.asarray(valid), True),
        *(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)),
    )
    refs = vjp(jnp.asarray(g, JDT[dtype]))
    outs = tattn.plain_attention_bwd(
        *(torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v)), torch.from_numpy(valid),
        torch.from_numpy(g).to(TDT[dtype]),
    )
    for out, ref in zip(outs, refs):
        assert out.dtype == TDT[dtype]
        np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


def test_qkv_function_matches_autograd_of_plain_forward_and_saves_only_qkv_and_mask():
    """fp32: the Function's CPU backward (the kernel's math, unrounded weights) equals
    autograd through the plain forward (rounded weights, the same in fp32)."""
    qkv, valid, g = _qkv_case(16, 2, 8)
    t_valid = torch.from_numpy(valid)
    a = torch.from_numpy(qkv).requires_grad_()
    out = tqkv.fused_qkv_causal_attention(a, t_valid, 2, 8)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2 and saved[0] is a and saved[1] is t_valid  # JAX's residuals only
    before = (tqkv.fused_qkv_causal_attention.launches, tqkv.fused_qkv_causal_attention_bwd.launches)
    out.backward(torch.from_numpy(g))
    b = torch.from_numpy(qkv).requires_grad_()
    tqkv.plain_qkv_causal_attention(b, t_valid, 2, 8).backward(torch.from_numpy(g))
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)
    assert (tqkv.fused_qkv_causal_attention.launches, tqkv.fused_qkv_causal_attention_bwd.launches) == before


def test_whole_sequence_function_matches_autograd_of_plain_forward():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 40, 2, 8)).astype(np.float32) for _ in range(3))
    valid = torch.from_numpy(_left_padded(rng, 2, 40))
    g = torch.from_numpy(rng.normal(size=(2, 40, 2, 8)).astype(np.float32)) * valid[..., None, None]
    first = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.fused_causal_attention(*first, valid)
    assert len(out.grad_fn.saved_tensors) == 4
    out.backward(g)
    second = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tattn.plain_causal_attention(*second, valid).backward(g)
    for x, y in zip(first, second):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-6)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


def test_kernel_route_is_differentiable(monkeypatch):
    """A tensor that is not on the CPU takes the kernels forward AND backward: the output
    carries a grad_fn and the backward reaches the backward kernel's wrapper, once per
    call. (Meta tensors stand in for CUDA ones; the launches are recorded, not run.)"""
    calls = []
    monkeypatch.setattr(_kernels, "attention_fwd", lambda *a: calls.append("fwd"))
    monkeypatch.setattr(_kernels, "attention_bwd", lambda *a: calls.append("bwd"))
    counts = lambda: (  # noqa: E731
        tqkv.fused_qkv_causal_attention.launches, tqkv.fused_qkv_causal_attention_bwd.launches,
        tattn.fused_causal_attention.launches, tattn.fused_causal_attention_bwd.launches,
    )
    before = counts()
    qkv = _meta(2, 16, 3 * 2 * 8).requires_grad_()
    valid = _meta(2, 16, dtype=torch.bool)
    out = tqkv.fused_qkv_causal_attention(qkv, valid, 2, 8)
    assert out.requires_grad and out.grad_fn is not None
    out.backward(_meta(2, 16, 16))
    assert qkv.grad.shape == qkv.shape
    q, k, v = (_meta(2, 256, 2, 8).requires_grad_() for _ in range(3))
    tattn.fused_causal_attention(q, k, v, _meta(2, 256, dtype=torch.bool)).backward(_meta(2, 256, 2, 8))
    assert q.grad.shape == k.grad.shape == v.grad.shape == (2, 256, 2, 8)
    assert calls == ["fwd", "bwd", "fwd", "bwd"]
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1, 1]


@pytest.mark.parametrize("entry", ["qkv", "whole_sequence"])
def test_backward_kernel_path_raises_without_nvcc(monkeypatch, tmp_path, entry):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "nvcc_path", no_nvcc)
    _kernels.library.cache_clear()
    if entry == "qkv":
        fn = tqkv.fused_qkv_causal_attention_bwd
        args = (_meta(2, 16, 48), _meta(2, 16, dtype=torch.bool), _meta(2, 16, 16), 2, 8)
    else:
        fn = tattn.fused_causal_attention_bwd
        args = (*(_meta(2, 256, 2, 8) for _ in range(3)), _meta(2, 256, dtype=torch.bool),
                _meta(2, 256, 2, 8))
    before = fn.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fn(*args)
    assert fn.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_lowp_vjp_matches_jax(dtype):
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(2, 3, 8, 8)) * 3).astype(np.float32)
    g = rng.normal(size=logits.shape).astype(np.float32)
    out_j, vjp = jax.vjp(lambda x: j_softmax_lowp(x, JDT[dtype]), jnp.asarray(logits))
    (ref,) = vjp(jnp.asarray(g, JDT[dtype]))
    x = torch.from_numpy(logits).requires_grad_()
    out = tattn.softmax_lowp(x, TDT[dtype])
    assert out.dtype == TDT[dtype]
    out.backward(torch.from_numpy(g).to(TDT[dtype]))
    np.testing.assert_allclose(_np(out), _np(out_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(x.grad), _np(ref), atol=1e-6, rtol=1e-6)


def test_relu_vjp_matches_jax_and_saves_only_its_output():
    x = np.array([-2.0, -0.0, 0.0, 1e-30, 0.5, 3.0], np.float32)
    g = np.arange(1, 7, dtype=np.float32)
    _, vjp = jax.vjp(j_relu, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    out = relu(t)
    # The only residual is the output itself: no saved input, no mask.
    assert [a for a in dir(out.grad_fn) if a.startswith("_saved_")] == ["_saved_result"]
    assert out.grad_fn._saved_result.data_ptr() == out.data_ptr()
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(ref))
