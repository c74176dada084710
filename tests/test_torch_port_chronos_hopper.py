"""The rounding order of the Chronos-2 attention kernels' bf16 wgmma route, against the JAX package.

The wgmma route (``csrc/chronos_attention_hopper.cu``, ``csrc/chronos_attention_bwd_hopper.cu``,
head_dim 64) runs only on the card; ``chip_smoke.py`` holds it against the plain versions
there. What can be checked here is its arithmetic: the models below repeat, in PyTorch on
the CPU, the order in which the kernels round, and are held against JAX's
``fused_chronos_attention`` and its VJP (the Pallas kernels in interpret mode, called as
``tests/test_torch_port_chronos_attention.py`` calls them) within the tolerances
``chip_smoke.py`` holds the kernels to (``KERNEL_TOL`` / ``BWD_TOL`` in bf16: 1e-2 + 1e-2
|reference|) on every element, at S = 65 and 193 (64 k + 1: the one-row tail of Chronos-2's
577 tokens) and 97, with one segment, several segments, and padded tokens with ids of their
own.

- Forward: 64-key tiles in order, a running row max m, the unnormalised weights
  P = exp(l - m) rounded to bf16 for the P V product (JAX rounds the normalised weights
  instead), the accumulator rescaled as m moves, one divide by the row sum at the end, the
  output rounded once.
- Backward: the row statistics from a pass of their own (m, s and r = rowsum(dW o W) in
  fp32, online over the key tiles), dL = W (dW - r) as a hi + lo pair of bf16 values for dQ
  and dK, W as such a pair for dV too (``tests/test_torch_port_dv_pair.py`` shows why), and
  dbias = dL in fp32, unrounded, summed over the
  batch rows in batch order. A case where dQ's terms cancel (K with a large common part)
  shows why: r = rowsum(G o O) from the bf16 output, or dL rounded once to bf16, leaves dQ
  outside the tolerance there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.ops.chronos_attention import fused_chronos_attention as j_chronos
from multimodal_timesfm_tpu.ops.chronos_attention import make_rowtile_bias
from multimodal_timesfm_torch.ops import chronos_attention as tca
from multimodal_timesfm_torch.ops.attention import NEG_INF
from multimodal_timesfm_torch.ops.qkv_attention import split_heads

BF16 = torch.bfloat16
TILE = 64  # keys (and query rows) per tile of the wgmma route
HEADS, DIM = 2, 64
# chip_smoke.py's KERNEL_TOL and BWD_TOL in bf16.
ATOL, RTOL = 1e-2, 1e-2


def _logits(qkv, seg, bias):
    """fp32 (B, H, S, S) q k^T + bias, finfo(float32).min across segments."""
    q, k, _ = split_heads(qkv, HEADS, DIM)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias[None]
    same = seg[:, :, None] == seg[:, None, :]
    return logits.masked_fill(~same[:, None], NEG_INF)


def hopper_forward(qkv, seg, bias):
    """The wgmma route's forward in its rounding order: (B, S, H*D) in qkv's dtype."""
    batch, seq, _ = qkv.shape
    _, _, v = split_heads(qkv, HEADS, DIM)
    logits = _logits(qkv, seg, bias)
    m = torch.full((batch, HEADS, seq, 1), torch.finfo(torch.float32).min)
    s = torch.zeros(batch, HEADS, seq, 1)
    acc = torch.zeros(batch, HEADS, seq, DIM)
    vh = v.float().permute(0, 2, 1, 3)
    for k0 in range(0, seq, TILE):
        tile = logits[..., k0 : k0 + TILE]
        new_m = torch.maximum(m, tile.amax(-1, keepdim=True))
        scale = torch.exp(m - new_m)
        p = torch.exp(tile - new_m)
        s = s * scale + p.sum(-1, keepdim=True)
        acc = acc * scale + p.to(BF16).float() @ vh[:, :, k0 : k0 + TILE]
        m = new_m
    return (acc / s).permute(0, 2, 1, 3).flatten(-2).to(qkv.dtype)


def hopper_backward(qkv, seg, bias, g, need_dbias=True, r_from="statistics", split=True):
    """The wgmma route's backward in its rounding order: (dqkv, dbias or None).

    ``r_from="statistics"`` is the route's choice (r = t / s from the statistics pass);
    ``"output"`` takes FlashAttention's r = rowsum(G o O) from the bf16 forward output.
    ``split=False`` rounds dL once to bf16 instead of as a hi + lo pair.
    """
    q, k, v = split_heads(qkv, HEADS, DIM)
    logits = _logits(qkv, seg, bias)
    g32 = g.unflatten(-1, (HEADS, DIM)).float()
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
        out = hopper_forward(qkv, seg, bias).float().unflatten(-1, (HEADS, DIM))
        r = (g32 * out).sum(-1).permute(0, 2, 1)[..., None]
    w = torch.exp(logits - m) * (1 / s)
    dl = w * (dw - r)
    hi = dl.to(BF16).float()
    dl_ab = hi + (dl - hi).to(BF16).float() if split else hi
    dq = torch.einsum("bhqk,bkhd->bqhd", dl_ab, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", dl_ab, q.float())
    w_hi = w.to(BF16).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", w_hi + (w - w_hi).to(BF16).float(), g32)
    dqkv = torch.cat([d.flatten(-2) for d in (dq, dk, dv)], dim=-1).to(qkv.dtype)
    if not need_dbias:
        return dqkv, None
    dbias = torch.zeros_like(bias)
    for b in range(dl.shape[0]):  # the dbias kernel's batch order
        dbias += dl[b]
    return dqkv, dbias


def _segments(rng, kind, batch, seq):
    """(B, S) int32 ids as the encoder builds them: "one" segment a row, "several" (three
    contiguous segments), or "padded" (three segments, a random fifth of the tokens padded,
    each with an id of its own); ids unique per (row, segment)."""
    parts = 1 if kind == "one" else 3
    base = np.repeat(np.arange(parts), -(-seq // parts))[:seq]
    row = np.arange(batch)[:, None]
    seg = np.broadcast_to(base[None] + row * (seq + 1), (batch, seq)).copy()
    if kind == "padded":
        pad = rng.random((batch, seq)) < 0.2
        tok = row * seq + np.arange(seq)[None, :]
        seg = np.where(pad, -1 - tok, seg)
    return seg.astype(np.int32)


def _case(seq, kind, shift=0.0, late_max=False, seed=0):
    """B = 2, H = 2, D = 64 inputs from a seed (entries of qkv about dim^-1/4, so logits are
    O(1), K shifted by ``shift``; with ``late_max`` the bias of the last key tile raised by 6
    so that every row's max arrives last), a N(0, 1) bias and a cotangent, as torch tensors
    and JAX arrays."""
    rng = np.random.default_rng(seed + seq)
    qkv = (rng.normal(size=(2, seq, 3 * HEADS * DIM)) / DIM ** 0.25).astype(np.float32)
    qkv[..., HEADS * DIM : 2 * HEADS * DIM] += shift
    bias = rng.normal(size=(HEADS, seq, seq)).astype(np.float32)
    if late_max:
        bias[..., (seq - 1) // TILE * TILE :] += 6.0
    seg = _segments(rng, kind, 2, seq)
    g = rng.normal(size=(2, seq, HEADS * DIM)).astype(np.float32)
    torch_in = (torch.from_numpy(qkv).to(BF16), torch.from_numpy(seg), torch.from_numpy(bias))
    return torch_in, torch.from_numpy(g).to(BF16), (qkv, seg, bias, g)


def _jax_forward(arrays):
    qkv, seg, bias, _ = arrays
    batch, seq, _ = qkv.shape
    return j_chronos(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(seg),
                     make_rowtile_bias(jnp.asarray(bias), batch, seq), HEADS, DIM, True)


@functools.cache
def _jax_vjp_of(seq, kind, shift, seed):
    """(dqkv, dbias) of JAX's kernel on :func:`_case`'s inputs, computed once per case: the
    VJP of its bias tiling reduces the block-diagonal cotangent to (H, S, S)."""
    return _jax_vjp(_case(seq, kind, shift=shift, seed=seed)[2])


def _jax_vjp(arrays):
    """(dqkv, dbias) of JAX's kernel on ``arrays``."""
    qkv, seg, bias, g = arrays
    batch, seq, _ = qkv.shape
    _, vjp = jax.vjp(
        lambda t, b: j_chronos(t, jnp.asarray(seg), make_rowtile_bias(b, batch, seq), HEADS, DIM, True),
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias),
    )
    return vjp(jnp.asarray(g, jnp.bfloat16))


def _excess(out, ref) -> float:
    """max(|out - ref| - atol - rtol |ref|): <= 0 within the tolerance, on every element."""
    out = out.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert out.shape == ref.shape and np.isfinite(out).all()
    return float((np.abs(out - ref) - ATOL - RTOL * np.abs(ref)).max())


KINDS = ["one", "several", "padded"]
LENGTHS = [65, 97, 193]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seq", LENGTHS)
def test_forward_rounding_order_matches_jax(seq, kind):
    (qkv, seg, bias), _, arrays = _case(seq, kind)
    out = hopper_forward(qkv, seg, bias)
    assert out.dtype == BF16 and out.shape == (2, seq, HEADS * DIM)
    assert _excess(out, _jax_forward(arrays)) <= 0


@pytest.mark.parametrize("need_dbias", [True, False])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seq", LENGTHS)
def test_backward_rounding_order_matches_jax_vjp(seq, kind, need_dbias):
    (qkv, seg, bias), g, _ = _case(seq, kind, seed=1)
    ref_dqkv, ref_dbias = _jax_vjp_of(seq, kind, 0.0, 1)
    dqkv, dbias = hopper_backward(qkv, seg, bias, g, need_dbias)
    assert dqkv.dtype == BF16
    assert _excess(dqkv, ref_dqkv) <= 0
    if need_dbias:
        assert dbias.dtype == torch.float32 and _excess(dbias, ref_dbias) <= 0
    else:
        assert dbias is None


def test_forward_holds_where_every_row_max_arrives_last():
    """The unnormalised weights of the early key tiles are rounded at a running max that the
    last tile (one key at S = 193 = 3 x 64 + 1) raises by about 6: they are rescaled by
    exp(-6) after their rounding, and the output stays within the tolerance."""
    (qkv, seg, bias), _, arrays = _case(193, "several", late_max=True, seed=2)
    assert _excess(hopper_forward(qkv, seg, bias), _jax_forward(arrays)) <= 0


@pytest.mark.parametrize("r_from,split,within", [
    ("statistics", True, True),    # the route's choice
    ("statistics", False, False),  # dL rounded once to bf16
    ("output", True, False),       # r = rowsum(G o O) from the bf16 output
])
def test_dq_where_its_terms_cancel(r_from, split, within):
    """K with a common part of 4 per element: the logits move by a per-row constant (the
    softmax does not see it) and dQ = sum dL K loses it exactly (sum dL = 0), so any
    error of dL's row sum, or of r, reaches dQ times that common part."""
    (qkv, seg, bias), g, _ = _case(193, "one", shift=4.0, seed=3)
    ref_dq = np.asarray(jnp.asarray(_jax_vjp_of(193, "one", 4.0, 3)[0], jnp.float32))[..., : HEADS * DIM]
    dqkv, _ = hopper_backward(qkv, seg, bias, g, False, r_from=r_from, split=split)
    assert (_excess(dqkv[..., : HEADS * DIM], ref_dq) <= 0) == within


@pytest.mark.parametrize("seq", LENGTHS)
def test_plain_versions_are_the_models_in_fp32(seq):
    """The plain versions the card holds the kernels to compute the models' function: in
    fp32 (every rounding the identity) the two agree to fp32 summation order."""
    (qkv, seg, bias), g, _ = _case(seq, "padded", seed=4)
    qkv32, g32 = qkv.float(), g.float()
    out = tca.plain_chronos_attention(qkv32, seg, bias)
    dqkv, dbias = tca.plain_chronos_attention_bwd(qkv32, seg, bias, g32)
    logits = _logits(qkv32, seg, bias)
    w = torch.softmax(logits, -1)
    _, _, v = split_heads(qkv32, HEADS, DIM)
    ref = torch.einsum("bhqk,bkhd->bqhd", w, v.float()).flatten(-2)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    # The model's bf16 roundings of dL (hi + lo: 2^-17) and W (2^-9, in [0, 1]) in fp32.
    model_dqkv, model_dbias = hopper_backward(qkv32, seg, bias, g32)
    torch.testing.assert_close(dbias, model_dbias, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dqkv, model_dqkv, rtol=2e-2, atol=2e-2)


def test_operands_not_16_byte_aligned_are_copied_aligned():
    """The wgmma route reads qkv and g by TMA, from 16-byte aligned bases: the wrappers hand
    it an aligned tensor as it is and copy one that is not (a view 2 bytes in)."""
    from multimodal_timesfm_torch.ops import _kernels

    flat = torch.arange(1 + 4 * 3 * HEADS * DIM, dtype=torch.float32).to(BF16)
    aligned = flat[:-1].view(4, 3 * HEADS * DIM)
    assert aligned.data_ptr() % 16 == 0 and _kernels._aligned16(aligned) is aligned
    shifted = flat[1:].view(4, 3 * HEADS * DIM)
    copy = _kernels._aligned16(shifted)
    assert shifted.data_ptr() % 16 != 0 and copy.data_ptr() % 16 == 0
    assert copy.is_contiguous() and torch.equal(copy, shifted)


def test_chip_smoke_names_the_route_and_its_kernel_families():
    """chip_smoke.py's kernels line carries the wgmma route's B4f and B4b with their own
    sources, the route's launches and the 16 x 577 row; its SASS check requires HGMMA and
    UTMALDG in each of the route's kernel families, which the sources define."""
    from pathlib import Path

    import chip_smoke

    shape = (16, 577, 12, 64)
    rows = {chip_smoke.row_key(key, shape, torch.bfloat16): {"ms": float(i)}
            for i, key in enumerate(("B4f", "B4b"))}
    entries = chip_smoke.wgmma_route_entries(rows, {"B4f wgmma": 3, "B4b wgmma": 5})
    assert [e["launches"] for e in entries] == [3, 5] and [e["ms"] for e in entries] == [0.0, 1.0]
    assert [Path(e["source"]).name for e in entries] == [
        "chronos_attention_hopper.cu", "chronos_attention_bwd_hopper.cu"]
    assert all(e["shape"] == "B=16 S=577 H=12 D=64 bfloat16" for e in entries)
    csrc = Path(chip_smoke.__file__).parent / "multimodal_timesfm_torch" / "csrc"
    text = "".join(p.read_text() for p in csrc.glob("chronos_attention*_hopper.cu"))
    families = [f for f in chip_smoke.WGMMA_FAMILIES if f.startswith("chronos_")]
    assert len(families) == 4 and all(f"    {f}(" in text for f in families)
