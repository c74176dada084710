"""The rounding order of the backwards' persistent one-pass route, against the JAX package.

The persistent route (``csrc/attention_bwd_short_hopper.cu`` for B1b, bf16 at head_dim 80
up to 64 tokens; ``csrc/chronos_attention_bwd_short_hopper.cu`` for B4b, bf16 at head_dim
64 up to 80 tokens) runs only on the card; ``chip_smoke.py`` holds it against the plain
versions there. What can be checked here is its arithmetic: the models below repeat, in
PyTorch on the CPU, the order in which the kernels round, and are held against JAX's
``fused_qkv_causal_attention`` and ``fused_chronos_attention`` VJPs (the Pallas kernels in
interpret mode, as the JAX package's own tests run them) within the tolerance
``chip_smoke.py`` holds the kernels to (``BWD_TOL`` in bf16: 1e-2 + 1e-2 |reference|) on
every element.

- The whole key row is one tile: the row max m and sum s are exact before any exponential
  (no online rescaling), W = exp(l - m) (1 / s) and r = rowsum(dW o W) in fp32, dL = W (dW
  - r) fed to dQ and dK as a hi + lo pair of bf16 values, W to dV as such a pair too (one
  bf16 rounding of W leaves dV outside the tolerance where its terms cancel).
- dbias (B4b): each block of the route owns one head and a contiguous range of batch rows
  (P blocks a head); each of its two consumer groups sums the dL of every other row of the
  range (rows 0, 2, ... and 1, 3, ...) in batch order, in fp32, in registers; the block's
  partial is group 0's sum plus group 1's, and the P partials are summed in order.
- B1b's causal mask: a query row with no valid key has uniform weights over all S keys in
  the port and over the packed row tile in JAX's kernel, so the cotangent is zero on such
  rows when the two are compared (as on the model path), and the model is held to the
  port's plain version on every row with a cotangent on every row.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.ops.chronos_attention import fused_chronos_attention as j_chronos
from multimodal_timesfm_tpu.ops.chronos_attention import make_rowtile_bias
from multimodal_timesfm_tpu.ops.qkv_attention import fused_qkv_causal_attention as j_fused_qkv
from multimodal_timesfm_torch.ops import chronos_attention as tca
from multimodal_timesfm_torch.ops.attention import NEG_INF, masked_logits
from multimodal_timesfm_torch.ops.qkv_attention import plain_qkv_attention_bwd, split_heads

BF16 = torch.bfloat16
# chip_smoke.py's BWD_TOL in bf16.
ATOL, RTOL = 1e-2, 1e-2
# The blocks a head of the Chronos route on an H100 (132 SMs, one block an SM at S = 67):
# 132 // H, each with two consumer groups.
SMS = 132


def _pair(x, split=True):
    """x as the route feeds it to the tensor cores: a hi + lo pair of bf16 values, or with
    ``split=False`` one bf16 rounding."""
    hi = x.to(BF16).float()
    return hi + (x - hi).to(BF16).float() if split else hi


def persistent_backward(logits, q, k, v, g, split=True, split_w=True):
    """The route's backward in its rounding order from fp32 (B, H, S, S) masked logits and
    (B, S, H, D) q, k, v and g: (dq, dk, dv) in fp32, unrounded, and dL.

    ``split=False`` rounds dL once to bf16 instead of as a hi + lo pair, ``split_w=False``
    W."""
    m = logits.amax(-1, keepdim=True)  # exact: every key of the row in one tile
    e = torch.exp(logits - m)
    w = e * (1 / e.sum(-1, keepdim=True))
    g32 = g.float()
    dw = torch.einsum("bqhd,bkhd->bhqk", g32, v.float())
    dl = w * (dw - (dw * w).sum(-1, keepdim=True))
    dl_ab = _pair(dl, split)
    dq = torch.einsum("bhqk,bkhd->bqhd", dl_ab, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", dl_ab, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", _pair(w, split_w), g32)
    return dq, dk, dv, dl


def causal_model(qkv, valid, g, heads, dim, split=True):
    """B1b on the persistent route: dqkv (B, S, 3*H*D) in qkv's dtype."""
    q, k, v = split_heads(qkv, heads, dim)
    dq, dk, dv, _ = persistent_backward(masked_logits(q, k, valid), q, k, v,
                                        g.unflatten(-1, (heads, dim)), split)
    return torch.cat([d.flatten(-2) for d in (dq, dk, dv)], dim=-1).to(qkv.dtype)


def dbias_partials(dl, blocks):
    """dbias from dL (B, H, S, S) as the route sums it with ``blocks`` blocks a head: each
    block's range [p B / P, (p + 1) B / P), its two groups' sums over every other row in
    batch order, the block's partial their sum (group 0's + group 1's), then the P partials
    in order."""
    batch = dl.shape[0]
    out = torch.zeros_like(dl[0])
    for p in range(blocks):
        b0, b1 = p * batch // blocks, (p + 1) * batch // blocks
        sums = []
        for grp in range(2):
            acc = torch.zeros_like(dl[0])
            for b in range(b0 + grp, b1, 2):
                acc = acc + dl[b]
            sums.append(acc)
        out = out + (sums[0] + sums[1])
    return out


def chronos_model(qkv, seg, bias, g, heads, dim, blocks, split_w=True):
    """B4b on the persistent route: (dqkv in qkv's dtype, dbias fp32)."""
    q, k, v = split_heads(qkv, heads, dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias[None]
    same = seg[:, :, None] == seg[:, None, :]
    logits = logits.masked_fill(~same[:, None], NEG_INF)
    dq, dk, dv, dl = persistent_backward(logits, q, k, v, g.unflatten(-1, (heads, dim)),
                                         split_w=split_w)
    dqkv = torch.cat([d.flatten(-2) for d in (dq, dk, dv)], dim=-1).to(qkv.dtype)
    return dqkv, dbias_partials(dl, blocks)


def _excess(out, ref) -> float:
    """max(|out - ref| - atol - rtol |ref|): <= 0 within the tolerance, on every element."""
    out = out.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert out.shape == ref.shape and np.isfinite(out).all()
    return float((np.abs(out - ref) - ATOL - RTOL * np.abs(ref)).max())


# ------------------------------------------------------------------------- B1b

B1_HEADS, B1_DIM = 2, 80


def _b1_case(seq, shift=0.0, every_row=False, seed=0):
    """B = 3 inputs from a seed (q pre-scaled, K shifted by ``shift``), left-padded keys with
    row 1 padded past its first half, so that its first query rows see no valid key, and a
    cotangent zero on padded query rows (or, with ``every_row``, on every row)."""
    rng = np.random.default_rng(seed + seq)
    hd = B1_HEADS * B1_DIM
    qkv = rng.normal(size=(3, seq, 3 * hd)).astype(np.float32)
    qkv[..., :hd] /= np.sqrt(B1_DIM)
    qkv[..., hd : 2 * hd] += shift
    pads = np.array([0, seq // 2 + 1, rng.integers(0, seq // 2 + 1)])
    valid = np.arange(seq)[None, :] >= pads[:, None]
    g = rng.normal(size=(3, seq, hd)).astype(np.float32)
    if not every_row:
        g *= valid[..., None]
    return qkv, valid, g


@functools.cache
def _b1_vjp(seq, shift=0.0, seed=0):
    qkv, valid, g = _b1_case(seq, shift, seed=seed)
    _, vjp = jax.vjp(lambda t: j_fused_qkv(t, jnp.asarray(valid), B1_HEADS, B1_DIM, True),
                     jnp.asarray(qkv, jnp.bfloat16))
    return vjp(jnp.asarray(g, jnp.bfloat16))[0]


def _b1_torch(seq, shift=0.0, every_row=False, seed=0):
    qkv, valid, g = _b1_case(seq, shift, every_row, seed)
    return torch.from_numpy(qkv).to(BF16), torch.from_numpy(valid), torch.from_numpy(g).to(BF16)


@pytest.mark.parametrize("seq", [8, 16, 17, 64])
def test_causal_route_matches_jax_vjp(seq):
    """Padded query rows included (a row with no valid key among them); S = 17 leaves 15
    padded rows and keys in the route's 32-row tile."""
    qkv, valid, g = _b1_torch(seq)
    assert not valid[1, : seq // 2].any()
    out = causal_model(qkv, valid, g, B1_HEADS, B1_DIM)
    assert out.dtype == BF16 and out.shape == qkv.shape
    assert _excess(out, _b1_vjp(seq)) <= 0


@pytest.mark.parametrize("seq", [16, 17])
def test_causal_route_matches_the_plain_version_on_every_row(seq):
    """With a cotangent on every row the rows with no valid key count too: their weights are
    uniform over all S keys in the route, as in the plain version the card holds it to."""
    qkv, valid, g = _b1_torch(seq, every_row=True)
    qkv32, g32 = qkv.float(), g.float()
    model = causal_model(qkv32, valid, g32, B1_HEADS, B1_DIM)
    torch.testing.assert_close(model, plain_qkv_attention_bwd(qkv32, valid, g32, B1_HEADS, B1_DIM),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("split,within", [(True, True), (False, False)])
def test_dq_where_its_terms_cancel(split, within):
    """K with a common part of 4 per element: dQ = sum dL K loses it exactly (each row of dL
    sums to 0), so an error of dL's row sum reaches dQ times that common part. The hi + lo
    pair keeps dQ within the tolerance; one bf16 rounding of dL does not."""
    qkv, valid, g = _b1_torch(16, shift=4.0, seed=3)
    dq = causal_model(qkv, valid, g, B1_HEADS, B1_DIM, split=split)[..., : B1_HEADS * B1_DIM]
    ref = np.asarray(jnp.asarray(_b1_vjp(16, 4.0, 3), jnp.float32))[..., : B1_HEADS * B1_DIM]
    assert (_excess(dq, ref) <= 0) == within


# ------------------------------------------------------------------------- B4b

B4_HEADS, B4_DIM = 2, 64


def _segments(rng, kind, batch, seq):
    """(B, S) int32 ids: "one" segment a row, "several" (three contiguous segments),
    "sixteen" (sixteen), or "padded" (three segments, a random fifth of the tokens padded,
    each with an id of its own); ids unique per (row, segment)."""
    parts = {"one": 1, "sixteen": 16}.get(kind, 3)
    base = np.repeat(np.arange(parts), -(-seq // parts))[:seq]
    row = np.arange(batch)[:, None]
    seg = np.broadcast_to(base[None] + row * (seq + 1), (batch, seq)).copy()
    if kind == "padded":
        pad = rng.random((batch, seq)) < 0.2
        seg = np.where(pad, -1 - (row * seq + np.arange(seq)[None, :]), seg)
    return seg.astype(np.int32)


def _b4_case(batch, seq, kind, seed=0, cancel=False):
    """Inputs from a seed: qkv entries of about dim^-1/4 (logits O(1)), a N(0, 1) bias and a
    cotangent, as numpy arrays. With ``cancel`` (and the "sixteen" segments of S / 16
    tokens) the cotangent is centred in each segment and scaled by 8."""
    rng = np.random.default_rng(seed + seq + batch)
    qkv = (rng.normal(size=(batch, seq, 3 * B4_HEADS * B4_DIM)) / B4_DIM ** 0.25).astype(np.float32)
    bias = rng.normal(size=(B4_HEADS, seq, seq)).astype(np.float32)
    seg = _segments(rng, kind, batch, seq)
    g = rng.normal(size=(batch, seq, B4_HEADS * B4_DIM)).astype(np.float32)
    if cancel:
        parts = g.reshape(batch, 16, seq // 16, -1)
        g = 8 * (parts - parts.mean(2, keepdims=True)).reshape(g.shape)
    return qkv, seg, bias, g


@functools.cache
def _b4_vjp(batch, seq, kind, cancel=False):
    """(dqkv, dbias) of JAX's kernel; the VJP of its bias tiling reduces the block-diagonal
    cotangent to (H, S, S)."""
    qkv, seg, bias, g = _b4_case(batch, seq, kind, cancel=cancel)
    _, vjp = jax.vjp(
        lambda t, b: j_chronos(t, jnp.asarray(seg), make_rowtile_bias(b, batch, seq), B4_HEADS, B4_DIM,
                               True),
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias),
    )
    return vjp(jnp.asarray(g, jnp.bfloat16))


def _b4_torch(batch, seq, kind, cancel=False):
    qkv, seg, bias, g = _b4_case(batch, seq, kind, cancel=cancel)
    return (torch.from_numpy(qkv).to(BF16), torch.from_numpy(seg), torch.from_numpy(bias),
            torch.from_numpy(g).to(BF16))


@pytest.mark.parametrize("seq,kind", [(64, "padded"), (67, "one"), (67, "several"), (67, "padded"),
                                      (80, "padded"), (80, "sixteen"), (96, "padded")])
def test_chronos_route_matches_jax_vjp(seq, kind):
    """S = 67: 13 padded keys and rows in the route's 80-row tile (72 keys computed); 64 and
    80 fill their tiles; 96, past the route's 80, checks the same arithmetic. Three batch
    rows over two blocks: one group of the second block has no row."""
    qkv, seg, bias, g = _b4_torch(3, seq, kind)
    ref_dqkv, ref_dbias = _b4_vjp(3, seq, kind)
    dqkv, dbias = chronos_model(qkv, seg, bias, g, B4_HEADS, B4_DIM, blocks=2)
    assert dqkv.dtype == BF16 and dbias.dtype == torch.float32
    assert _excess(dqkv, ref_dqkv) <= 0
    assert _excess(dbias, ref_dbias) <= 0


@pytest.mark.parametrize("split_w,within", [(True, True), (False, False)])
def test_dv_where_its_terms_cancel(split_w, within):
    """Sixteen segments of 5 tokens at S = 80 and a cotangent centred in each segment: dV =
    W^T G keeps only the spread of W over a segment's rows, so W's rounding reaches dV times
    |G| while dV stays small. W as a hi + lo pair keeps dV within the tolerance; one bf16
    rounding of W does not (as on the card at 512 x 80 x 12 heads with a N(0, 1) cotangent)."""
    hd = B4_HEADS * B4_DIM
    qkv, seg, bias, g = _b4_torch(3, 80, "sixteen", cancel=True)
    dqkv, _ = chronos_model(qkv, seg, bias, g, B4_HEADS, B4_DIM, blocks=2, split_w=split_w)
    ref = np.asarray(jnp.asarray(_b4_vjp(3, 80, "sixteen", True)[0], jnp.float32))
    assert _excess(dqkv[..., : 2 * hd], ref[..., : 2 * hd]) <= 0
    assert (_excess(dqkv[..., 2 * hd :], ref[..., 2 * hd :]) <= 0) == within


@pytest.mark.parametrize("heads", [12, 6])
def test_dbias_over_the_route_partition_at_batch_128(heads):
    """Chronos-2's fine-tune batch of 128 rows, cut as the route cuts it at 12 heads (11
    blocks a head) and at 6 (22), each block's two groups summed apart: dbias stays within
    the tolerance of JAX's (the same for any cut). Two heads of data: a head's dbias depends
    on that head only."""
    blocks = SMS // heads
    qkv, seg, bias, g = _b4_torch(128, 67, "padded")
    _, dbias = chronos_model(qkv, seg, bias, g, B4_HEADS, B4_DIM, blocks)
    assert _excess(dbias, _b4_vjp(128, 67, "padded")[1]) <= 0
    _, plain = tca.plain_chronos_attention_bwd(qkv.float(), seg, bias, g.float())
    torch.testing.assert_close(dbias, plain, rtol=1e-4, atol=1e-4)


def test_dbias_partition_is_every_row_once_in_batch_order():
    """The cut covers each batch row once, every group's rows in increasing order."""
    batch, blocks = 128, 11
    seen = []
    for p in range(blocks):
        b0, b1 = p * batch // blocks, (p + 1) * batch // blocks
        assert 11 <= b1 - b0 <= 12
        for grp in range(2):
            rows = list(range(b0 + grp, b1, 2))
            assert rows == sorted(rows)
            seen += rows
    assert sorted(seen) == list(range(batch))
    marks = torch.arange(batch, dtype=torch.float32)[:, None, None, None].expand(batch, 1, 1, 1)
    assert dbias_partials(marks, blocks).item() == sum(range(batch))


# ------------------------------------------------------------------ chip_smoke.py


def test_chip_smoke_names_the_persistent_route_and_its_kernel_families():
    """chip_smoke.py's kernels line gives B1b and B4b the persistent route's sources, its
    SASS check requires HMMA and UTMALDG in the route's two kernel families (defined in
    those sources, which the library builds), and its launch split names the route."""
    import chip_smoke

    from multimodal_timesfm_torch.ops import _kernels

    sources = {key: Path(cu).name for key, _, cu, *_ in chip_smoke.KERNELS}
    assert sources["B1b"] == "attention_bwd_short_hopper.cu"
    assert sources["B4b"] == "chronos_attention_bwd_short_hopper.cu"
    assert {Path(p).name for p in _kernels.SOURCES} >= set(sources.values())
    assert chip_smoke.PERSISTENT_FAMILIES[:2] == ("attention_bwd_short_kernel", "chronos_bwd_short_kernel")
    for family, cu in zip(chip_smoke.PERSISTENT_FAMILIES, (sources["B1b"], sources["B4b"])):
        assert f"    {family}(" in (_kernels.CSRC / cu).read_text()
    assert chip_smoke.B1_ROUTES[3] == chip_smoke.B4_ROUTES[4] == "persistent"
    # the rule takes it; "cuda cores" is the fp32 override
    assert set(_kernels.ROUTE_NAMES) == {"rule", "mma.sync", "wgmma", "cuda cores", "tf32 mma.sync", "tf32 wgmma"}
    assert "persistent" in _kernels._ROUTES[3] and "persistent" in _kernels._CHRONOS_ROUTES[4]
    assert {"B1b", "B4f", "B4b"} <= set(chip_smoke.ROUTED_KEYS)
