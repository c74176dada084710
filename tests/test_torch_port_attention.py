"""PyTorch port vs the JAX package: the plain versions of the two attention kernels.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as its own
tests do. Inputs are drawn with numpy from a seed, with left-padded key masks.
Valid query rows are compared against the kernels; padded query rows have no
valid key and their output depends on the JAX kernel's row-tile packing
(uniform weights over the tile), so there only finiteness is checked. Against
JAX's XLA path every row is compared, under masks with whole 64-row tiles of
padding and with holes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.ops.attention import fused_causal_attention as j_fused
from multimodal_timesfm_tpu.ops.attention import xla_causal_attention
from multimodal_timesfm_tpu.ops.qkv_attention import fused_qkv_causal_attention as j_fused_qkv
from multimodal_timesfm_torch.models.layers import Attention
from multimodal_timesfm_torch.ops.attention import (
    fused_causal_attention,
    needs_flash,
    plain_causal_attention,
    supports_fused,
)
from multimodal_timesfm_torch.ops.qkv_attention import (
    fused_qkv_causal_attention,
    plain_qkv_causal_attention,
    supports_qkv_fused,
)

# fp32: the same masked softmax, summation order only. bf16: the weights are
# rounded to bf16 before PV on both sides and the output is rounded once, so
# the two may land one bf16 ulp (2^-8 relative) apart.
TOL = {"float32": dict(atol=2e-5, rtol=1e-5), "bfloat16": dict(atol=1.6e-2, rtol=1e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _left_padded(rng, batch, seq):
    pads = rng.integers(0, seq // 2, size=batch)
    pads[0] = 0
    return np.arange(seq)[None, :] >= pads[:, None]


def _compare(out, ref, valid, dtype):
    out = out.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert np.isfinite(out).all()
    rows = valid.reshape(valid.shape + (1,) * (out.ndim - 2))
    np.testing.assert_allclose(out * rows, ref * rows, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq,heads,dim", [(16, 4, 8), (64, 2, 16), (8, 3, 8)])
def test_plain_qkv_matches_jax_kernel(seq, heads, dim, dtype):
    rng = np.random.default_rng(seq + heads)
    qkv = rng.normal(size=(3, seq, 3 * heads * dim)).astype(np.float32)
    qkv[..., : heads * dim] /= np.sqrt(dim)
    valid = _left_padded(rng, 3, seq)
    ref = j_fused_qkv(jnp.asarray(qkv, JDT[dtype]), jnp.asarray(valid), heads, dim, True)
    t_qkv = torch.from_numpy(qkv).to(TDT[dtype])
    out = plain_qkv_causal_attention(t_qkv, torch.from_numpy(valid), heads, dim)
    assert out.dtype == TDT[dtype] and out.shape == (3, seq, heads * dim)
    _compare(out, ref, valid, dtype)
    # The public wrapper takes the plain version for a CPU tensor.
    wrapped = fused_qkv_causal_attention(t_qkv, torch.from_numpy(valid), heads, dim)
    torch.testing.assert_close(wrapped, out, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_whole_sequence_matches_jax_kernel(dtype):
    rng = np.random.default_rng(7)
    batch, seq, heads, dim = 2, 256, 2, 8
    q, k, v = (rng.normal(size=(batch, seq, heads, dim)).astype(np.float32) for _ in range(3))
    q /= np.sqrt(dim)
    valid = _left_padded(rng, batch, seq)
    ref = j_fused(*(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)), jnp.asarray(valid), True)
    tq, tk, tv = (torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v))
    out = plain_causal_attention(tq, tk, tv, torch.from_numpy(valid))
    _compare(out, ref, valid, dtype)
    before = fused_causal_attention.launches
    wrapped = fused_causal_attention(tq, tk, tv, torch.from_numpy(valid))
    torch.testing.assert_close(wrapped, out, rtol=0, atol=0)
    assert fused_causal_attention.launches == before


def test_plain_path_matches_xla_path_on_a_fully_masked_row():
    """A query row with no valid key stays finite: uniform weights, as in JAX's XLA path."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(1, 12, 2, 4)).astype(np.float32) for _ in range(3))
    valid = np.ones((1, 12), bool)
    valid[0, :5] = False
    ref = xla_causal_attention(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(valid))
    out = plain_causal_attention(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy()[0, 0], v.mean(axis=1)[0], atol=1e-5)


def _skip_rule_mask(rng, kind, batch, seq):
    """Masks that exercise the CUDA kernels' skip rule. "deep": a left pad in [64, S - 1],
    so whole 64-row query tiles have no valid key (row 0 keeps only its last key).
    "holes": left-padded, then each later key invalid with probability 0.3 (the first
    valid key kept); the last row has no valid key at all."""
    ar = np.arange(seq)[None, :]
    if kind == "deep":
        pads = rng.integers(64, seq, size=batch)
        pads[0] = seq - 1
        return ar >= pads[:, None]
    valid = _left_padded(rng, batch, seq)
    first = valid.argmax(axis=1)
    valid &= (rng.random((batch, seq)) >= 0.3) | (ar == first[:, None])
    valid[-1] = False
    return valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["deep", "holes"])
def test_plain_matches_xla_path_on_every_row_under_skip_rule_masks(kind, dtype):
    """Every query row, those with no valid key included, against JAX's XLA path; a row
    with no valid key is the mean of V over all S keys (uniform weights)."""
    rng = np.random.default_rng(21 if kind == "deep" else 22)
    batch, seq, heads, dim = 3, 200, 2, 8
    q, k, v = (rng.normal(size=(batch, seq, heads, dim)).astype(np.float32) for _ in range(3))
    q /= np.sqrt(dim)
    valid = _skip_rule_mask(rng, kind, batch, seq)
    assert (~valid[:, :64]).all(axis=1).any()  # a whole 64-row tile without a valid key
    ref = xla_causal_attention(*(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)), jnp.asarray(valid))
    tq, tk, tv = (torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v))
    out = plain_causal_attention(tq, tk, tv, torch.from_numpy(valid))
    _compare(out, ref, np.ones_like(valid), dtype)
    first = np.where(valid.any(axis=1), valid.argmax(axis=1), seq)
    mean = tv.float().mean(dim=1).numpy()  # (B, H, D)
    for b in range(batch):
        rows = out[b, : first[b]].float().numpy()
        np.testing.assert_allclose(rows, np.broadcast_to(mean[b], rows.shape), **TOL[dtype])


def test_kernel_gates_hold_only_cuda_tensors():
    cpu = torch.zeros(1)
    assert not supports_qkv_fused(cpu, 64, 80)
    assert not supports_fused(cpu, 512, 80)
    assert not needs_flash(cpu, 4096, 80)


def test_long_sequence_on_cpu_takes_the_plain_path():
    """Beyond 2048 tokens JAX needs its flash kernel on the TPU; on CPU tensors the port
    (like JAX off the TPU) runs the plain path. On CUDA it takes the flash entry point
    (tests/test_torch_port_chronos_attention.py, chip_smoke.py)."""
    attn = Attention(8, 2, 4, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 2056, 8)).astype(np.float32))
    with torch.inference_mode():
        out = attn(x, torch.zeros(1, 2056, dtype=torch.bool))
    assert out.shape == (1, 2056, 8) and torch.isfinite(out).all()
