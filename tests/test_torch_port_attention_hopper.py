"""The rounding order of the causal attention kernels' bf16 wgmma route, against the JAX package.

The wgmma route (``csrc/attention_fwd_hopper.cu``, ``csrc/attention_bwd_hopper.cu``)
runs only on the card; ``chip_smoke.py`` holds it against the plain versions there.
What can be checked here is its arithmetic: the models below repeat, in PyTorch on the
CPU, the order in which the kernels round, and are held against JAX's
``fused_causal_attention`` and its VJP (the Pallas kernels in interpret mode, as the JAX
package's own tests run them) within the tolerances ``chip_smoke.py`` holds the kernels
to (``KERNEL_TOL`` / ``BWD_TOL`` in bf16: 1e-2 + 1e-2 |reference|), on every row, under
the three masks of the skip rule.

- Forward: 64-key tiles in order, a running row max m, the unnormalised weights
  P = exp(l - m) rounded to bf16 for the P V product (JAX rounds the normalised
  weights instead), the accumulator rescaled as m moves, one divide by the row sum at
  the end, the output rounded once.
- Backward: the row statistics from a pass of their own (m, s and r = rowsum(dW o W)
  in fp32), dL = W (dW - r) as a hi + lo pair of bf16 values for dQ and dK, W as such a
  pair for dV too (``tests/test_torch_port_dv_pair.py`` shows why). A case where dQ's terms
  cancel (K with a large common part) shows
  why: FlashAttention's r = rowsum(G o O) from the bf16 output, or dL rounded once to
  bf16, leaves dQ outside the tolerance there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.ops.attention import fused_causal_attention as j_fused
from multimodal_timesfm_torch.ops.attention import (
    masked_logits,
    plain_attention_bwd,
    plain_causal_attention,
)

BF16 = torch.bfloat16
TILE = 64  # keys per tile of the wgmma route
# chip_smoke.py's KERNEL_TOL and BWD_TOL in bf16, and fp32's for the control.
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
JDT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def hopper_forward(q, k, v, valid):
    """The wgmma route's forward in its rounding order (q, k, v: (B, S, H, D))."""
    batch, seq, heads, dim = q.shape
    logits = masked_logits(q, k, valid)
    m = torch.full((batch, heads, seq, 1), torch.finfo(torch.float32).min)
    s = torch.zeros(batch, heads, seq, 1)
    acc = torch.zeros(batch, heads, seq, dim)
    vh = v.float().permute(0, 2, 1, 3)
    for k0 in range(0, seq, TILE):
        tile = logits[..., k0 : k0 + TILE]
        new_m = torch.maximum(m, tile.amax(-1, keepdim=True))
        scale = torch.exp(m - new_m)
        p = torch.exp(tile - new_m)
        s = s * scale + p.sum(-1, keepdim=True)
        acc = acc * scale + p.to(BF16).float() @ vh[:, :, k0 : k0 + TILE]
        m = new_m
    return (acc / s).permute(0, 2, 1, 3).to(q.dtype)


def hopper_backward(q, k, v, valid, g, r_from="statistics", split=True):
    """The wgmma route's backward in its rounding order: (dq, dk, dv).

    ``r_from="statistics"`` is the route's choice (r = t / s from the statistics pass);
    ``"output"`` takes FlashAttention's r = rowsum(G o O) from the bf16 forward output.
    ``split=False`` rounds dL once to bf16 instead of as a hi + lo pair.
    """
    logits = masked_logits(q, k, valid)
    g32 = g.float()
    dw = torch.einsum("bqhd,bkhd->bhqk", g32, v.float())
    m = torch.full(logits.shape[:-1] + (1,), torch.finfo(torch.float32).min)
    s = torch.zeros_like(m)
    t = torch.zeros_like(m)
    for k0 in range(0, logits.shape[-1], TILE):  # the statistics pass, online
        tile = logits[..., k0 : k0 + TILE]
        new_m = torch.maximum(m, tile.amax(-1, keepdim=True))
        scale = torch.exp(m - new_m)
        e = torch.exp(tile - new_m)
        s = s * scale + e.sum(-1, keepdim=True)
        t = t * scale + (e * dw[..., k0 : k0 + TILE]).sum(-1, keepdim=True)
        m = new_m
    if r_from == "statistics":
        r = t / s
    else:
        out = hopper_forward(q, k, v, valid).float()
        r = (g32 * out).sum(-1).permute(0, 2, 1)[..., None]
    w = torch.exp(logits - m) * (1 / s)
    dl = w * (dw - r)
    hi = dl.to(BF16).float()
    dl = hi + (dl - hi).to(BF16).float() if split else hi
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, q.float())
    w_hi = w.to(BF16).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", w_hi + (w - w_hi).to(BF16).float(), g32)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _mask(rng, kind, batch, seq):
    """chip_smoke.py's skip-rule masks: "left-padded" (a pad in [0, S/2)), "deep padding"
    (a pad in [min(128, S - 1), S - 1], row 0 keeping only its last key, so whole query
    tiles see no valid key) and "holes" (left-padded, each later key invalid with
    probability 0.3, the first valid key kept, the last row with no valid key)."""
    ar = np.arange(seq)[None, :]
    if kind == "deep padding":
        pads = rng.integers(min(128, seq - 1), seq, size=batch)
        pads[0] = seq - 1
        return ar >= pads[:, None]
    pads = rng.integers(0, seq // 2, size=batch)
    pads[0] = 0
    valid = ar >= pads[:, None]
    if kind == "holes":
        first = valid.argmax(axis=1)
        valid &= (rng.random((batch, seq)) >= 0.3) | (ar == first[:, None])
        valid[-1] = False
    return valid


def _case(seq, kind, dtype=BF16, shift=0.0, seed=0):
    """B = 2, H = 2, D = 80 inputs from a seed (q pre-scaled, K shifted by ``shift``), a
    mask of ``kind`` and a cotangent on every row, as torch tensors and JAX arrays."""
    rng = np.random.default_rng(seed + seq)
    q, k, v, g = (rng.normal(size=(2, seq, 2, 80)).astype(np.float32) for _ in range(4))
    q /= np.sqrt(80)
    k += shift
    valid = _mask(rng, kind, 2, seq)
    torch_in = tuple(torch.from_numpy(x).to(dtype) for x in (q, k, v)) + (torch.from_numpy(valid),)
    jax_in = tuple(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)) + (jnp.asarray(valid),)
    return torch_in, torch.from_numpy(g).to(dtype), jax_in, jnp.asarray(g, JDT[dtype])


def _jax_vjp(jax_in, g):
    q, k, v, valid = jax_in
    _, vjp = jax.vjp(lambda a, b, c: j_fused(a, b, c, valid, True), q, k, v)
    return vjp(g)


def _excess(out, ref, dtype) -> float:
    """max(|out - ref| - atol - rtol |ref|): <= 0 within the tolerance."""
    atol, rtol = TOL[dtype]
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert np.isfinite(out).all()
    return float((np.abs(out - ref) - atol - rtol * np.abs(ref)).max())


MASKS = ["left-padded", "deep padding", "holes"]


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("seq", [256, 300])
def test_forward_rounding_order_matches_jax(seq, kind):
    (q, k, v, valid), _, jax_in, _ = _case(seq, kind)
    ref = j_fused(*jax_in, True)
    assert _excess(hopper_forward(q, k, v, valid), ref, BF16) <= 0


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("seq", [256, 300])
def test_backward_rounding_order_matches_jax_vjp(seq, kind):
    (q, k, v, valid), g, jax_in, jg = _case(seq, kind)
    refs = _jax_vjp(jax_in, jg)
    for out, ref in zip(hopper_backward(q, k, v, valid, g), refs):
        assert out.dtype == BF16
        assert _excess(out, ref, BF16) <= 0


@pytest.mark.parametrize("r_from,split,within", [
    ("statistics", True, True),    # the route's choice
    ("statistics", False, False),  # dL rounded once to bf16
    ("output", True, False),       # r = rowsum(G o O) from the bf16 output
])
def test_dq_where_its_terms_cancel(r_from, split, within):
    """K with a common part of 4 per element: the logits move by a per-row constant (the
    softmax does not see it) and dQ = sum dL K loses it exactly (sum dL = 0), so any
    error of dL's row sum, or of r, reaches dQ times that common part."""
    (q, k, v, valid), g, jax_in, jg = _case(256, "left-padded", shift=4.0, seed=3)
    dq_ref = _jax_vjp(jax_in, jg)[0]
    dq = hopper_backward(q, k, v, valid, g, r_from=r_from, split=split)[0]
    assert (_excess(dq, dq_ref, BF16) <= 0) == within


@pytest.mark.parametrize("seq", [256, 300])
def test_fp32_plain_versions_match_jax(seq):
    """Control: the fp32 route's plain versions, which this route leaves as they are."""
    (q, k, v, valid), g, jax_in, jg = _case(seq, "holes", dtype=torch.float32)
    assert _excess(plain_causal_attention(q, k, v, valid), j_fused(*jax_in, True), torch.float32) <= 0
    for out, ref in zip(plain_attention_bwd(q, k, v, valid, g), _jax_vjp(jax_in, jg)):
        assert _excess(out, ref, torch.float32) <= 0
