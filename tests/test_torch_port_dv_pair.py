"""dV = W^T G on the older bf16 backward routes where dV's terms cancel, against the JAX package.

The routes below run only on the card; ``chip_smoke.py`` holds them against the plain
versions there at these lengths (``CAUSAL_DV_CANCEL_SHAPES``, ``CHRONOS_DV_CANCEL_SHAPES``).
Each takes dV = (W_hi + W_lo)^T G, W as a hi + lo pair of bf16 values with W_lo = bf16(W -
W_hi), as JAX keeps W in fp32 there (``ops/qkv_attention.py:175``, ``ops/attention.py:205``,
``ops/chronos_attention.py:179``):

- the causal ``mma.sync`` route (``csrc/attention_bwd.cu``): B1b at 65-127 tokens at head_dim
  80, every bf16 length at other head dims;
- the causal wgmma route (``csrc/attention_bwd_hopper.cu``): B1b from 128 tokens, B2b, B3b;
- the Chronos one-pass route (``csrc/chronos_attention_bwd.cu``): B4b at 81-96 tokens at
  head_dim 64; its tiled route (the same file): B4b at other head dims;
- the Chronos wgmma route (``csrc/chronos_attention_bwd_hopper.cu``): B4b from 97 tokens.

The model is ``persistent_backward`` (``tests/test_torch_port_short_backward.py``): W and dL
in fp32 from the exact row max and sum, dL fed to dQ and dK as a hi + lo pair. The routes
here take the row statistics from an online pass, which moves W by fp32 roundings only; the
rounding of W for dV is what these tests turn on. The cotangent is centred over each segment's
rows (Chronos, sixteen segments a row) or over each block of 16 query rows (causal, every key
valid), times 8: dV keeps only W's spread over those rows while a rounding of W reaches it
times |G|. W as the pair keeps every gradient within ``BWD_TOL`` (1e-2 + 1e-2 |reference|,
``chip_smoke.py``) of JAX's VJP (the Pallas kernels in interpret mode); W rounded once to
bf16 leaves dV outside it in every case here, at seed 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.ops.attention import fused_causal_attention as j_fused
from multimodal_timesfm_tpu.ops.chronos_attention import fused_chronos_attention as j_chronos
from multimodal_timesfm_tpu.ops.chronos_attention import make_rowtile_bias
from multimodal_timesfm_tpu.ops.qkv_attention import fused_qkv_causal_attention as j_fused_qkv
from multimodal_timesfm_torch.ops.attention import NEG_INF, masked_logits
from multimodal_timesfm_torch.ops.qkv_attention import split_heads
from tests.test_torch_port_short_backward import _excess, _segments, persistent_backward

BF16 = torch.bfloat16
HEADS = 2
SCALE = 8.0  # the centred cotangent's scale
BLOCK = 16  # query rows a causal cotangent is centred over
SEED = 0


def _centred(g, groups):
    """SCALE times g (B, S, C) less its mean over the rows of each group (groups: (B, S) ids)."""
    same = (groups[:, :, None] == groups[:, None, :]).astype(np.float32)
    mean = np.einsum("bqk,bkc->bqc", same, g) / same.sum(-1, keepdims=True)
    return (SCALE * (g - mean)).astype(np.float32)


# --------------------------------------------------------------------- Chronos

# (route, S, head_dim): one-pass at 96 tokens, wgmma at 577, tiled at head_dim 128.
CHRONOS_CASES = [("one-pass", 96, 64), ("wgmma", 577, 64), ("tiled", 80, 128)]


def _chronos_case(seq, dim, batch=2):
    """qkv (entries of about dim^-1/4), a N(0, 1) bias, sixteen segments a row and the cotangent
    centred in each, as numpy arrays."""
    rng = np.random.default_rng(SEED + seq + dim)
    qkv = (rng.normal(size=(batch, seq, 3 * HEADS * dim)) / dim ** 0.25).astype(np.float32)
    bias = rng.normal(size=(HEADS, seq, seq)).astype(np.float32)
    seg = _segments(rng, "sixteen", batch, seq)
    g = _centred(rng.normal(size=(batch, seq, HEADS * dim)).astype(np.float32), seg)
    return qkv, seg, bias, g


@functools.cache
def _chronos_vjp(seq, dim):
    qkv, seg, bias, g = _chronos_case(seq, dim)
    batch = qkv.shape[0]
    _, vjp = jax.vjp(
        lambda t: j_chronos(t, jnp.asarray(seg), make_rowtile_bias(jnp.asarray(bias), batch, seq), HEADS,
                            dim, True),
        jnp.asarray(qkv, jnp.bfloat16),
    )
    return np.asarray(jnp.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0], jnp.float32))


def chronos_dqkv(seq, dim, split_w):
    """The routes' dqkv in bf16 from the model, W for dV as the pair or (``split_w=False``)
    one bf16 value."""
    qkv, seg, bias, g = _chronos_case(seq, dim)
    qkv, g = torch.from_numpy(qkv).to(BF16), torch.from_numpy(g).to(BF16)
    q, k, v = split_heads(qkv, HEADS, dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + torch.from_numpy(bias)[None]
    same = torch.from_numpy(seg[:, :, None] == seg[:, None, :])
    logits = logits.masked_fill(~same[:, None], NEG_INF)
    dq, dk, dv, _ = persistent_backward(logits, q, k, v, g.unflatten(-1, (HEADS, dim)), split_w=split_w)
    return torch.cat([d.flatten(-2) for d in (dq, dk, dv)], dim=-1).to(BF16)


@pytest.mark.parametrize("route,seq,dim", CHRONOS_CASES)
def test_chronos_dqkv_with_w_as_a_pair_within_tolerance(route, seq, dim):
    """Every element of dq, dk and dv within BWD_TOL of JAX's VJP at the route's own length."""
    assert _excess(chronos_dqkv(seq, dim, True), _chronos_vjp(seq, dim)) <= 0


@pytest.mark.parametrize("route,seq,dim", CHRONOS_CASES)
def test_chronos_dv_with_w_as_one_bf16_value_outside_tolerance(route, seq, dim):
    """The fault the pair repairs: dV from W rounded once to bf16 leaves BWD_TOL (dq and dk,
    which do not read W, stay inside)."""
    cut = 2 * HEADS * dim
    dqkv, ref = chronos_dqkv(seq, dim, False), _chronos_vjp(seq, dim)
    assert _excess(dqkv[..., :cut], ref[..., :cut]) <= 0
    assert _excess(dqkv[..., cut:], ref[..., cut:]) > 0


# ---------------------------------------------------------------------- causal

DIM = 80
# (route, S): mma.sync at 96 tokens (through B1b's fused-qkv entry point), wgmma at 512
# (through B2b's whole-sequence one).
CAUSAL_CASES = [("mma.sync", 96), ("wgmma", 512)]


def _causal_case(seq, batch=2):
    """qkv (q pre-scaled), every key valid, the cotangent centred over blocks of BLOCK rows."""
    rng = np.random.default_rng(SEED + seq)
    hd = HEADS * DIM
    qkv = rng.normal(size=(batch, seq, 3 * hd)).astype(np.float32)
    qkv[..., :hd] /= np.sqrt(DIM)
    blocks = np.broadcast_to(np.arange(seq) // BLOCK, (batch, seq))
    g = _centred(rng.normal(size=(batch, seq, hd)).astype(np.float32), blocks)
    return qkv, np.ones((batch, seq), bool), g


@functools.cache
def _causal_vjp(seq):
    """JAX's dqkv (B, S, 3*H*D): its fused-qkv kernel below 256 tokens, its whole-sequence
    kernel from 256, each the kernel the port's route serves at that length."""
    qkv, valid, g = _causal_case(seq)
    jqkv, jvalid, jg = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(valid), jnp.asarray(g, jnp.bfloat16)
    if seq < 256:
        _, vjp = jax.vjp(lambda t: j_fused_qkv(t, jvalid, HEADS, DIM, True), jqkv)
        out = vjp(jg)[0]
    else:
        hd = HEADS * DIM
        parts = [jqkv[..., i * hd : (i + 1) * hd].reshape(*qkv.shape[:2], HEADS, DIM) for i in range(3)]
        _, vjp = jax.vjp(lambda a, b, c: j_fused(a, b, c, jvalid, True), *parts)
        out = jnp.concatenate([d.reshape(*qkv.shape[:2], hd) for d in vjp(jg.reshape(*qkv.shape[:2], HEADS, DIM))],
                              axis=-1)
    return np.asarray(jnp.asarray(out, jnp.float32))


def causal_dqkv(seq, split_w):
    qkv, valid, g = _causal_case(seq)
    qkv, valid, g = torch.from_numpy(qkv).to(BF16), torch.from_numpy(valid), torch.from_numpy(g).to(BF16)
    q, k, v = split_heads(qkv, HEADS, DIM)
    dq, dk, dv, _ = persistent_backward(masked_logits(q, k, valid), q, k, v, g.unflatten(-1, (HEADS, DIM)),
                                        split_w=split_w)
    return torch.cat([d.flatten(-2) for d in (dq, dk, dv)], dim=-1).to(BF16)


@pytest.mark.parametrize("route,seq", CAUSAL_CASES)
def test_causal_dqkv_with_w_as_a_pair_within_tolerance(route, seq):
    assert _excess(causal_dqkv(seq, True), _causal_vjp(seq)) <= 0


@pytest.mark.parametrize("route,seq", CAUSAL_CASES)
def test_causal_dv_with_w_as_one_bf16_value_outside_tolerance(route, seq):
    cut = 2 * HEADS * DIM
    dqkv, ref = causal_dqkv(seq, False), _causal_vjp(seq)
    assert _excess(dqkv[..., :cut], ref[..., :cut]) <= 0
    assert _excess(dqkv[..., cut:], ref[..., cut:]) > 0
