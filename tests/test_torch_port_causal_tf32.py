"""The 3xTF32 route of the causal kernels B1-B3 (fp32, head_dim 80), against the JAX package.

The route (``csrc/attention_fwd_tf32.cu``, ``csrc/attention_bwd_tf32.cu``, route 4 of
``attention_fwd_config`` / ``attention_bwd_config``) runs only on the card; ``chip_smoke.py``
holds it against the plain versions there. What can be checked here is its arithmetic: the
model below repeats, in PyTorch on the CPU, what the kernels compute and in which order, and is
held against JAX's ``fused_qkv_causal_attention`` (B1) and ``fused_causal_attention`` (B2) in
fp32 (the Pallas kernels in interpret mode, as the JAX package's own tests run them) and their
VJPs, within the tolerances ``chip_smoke.py`` holds the kernels to (``KERNEL_TOL`` and
``BWD_TOL`` in fp32).

- The products: ``tests/test_torch_tf32_model.py`` (the split, three products per k-step of 8).
- Tiles: S padded to 16 up to 80 tokens (one tile), else 64 rows. Each query tile walks the key
  tiles the skip rule keeps (``key_tiles`` in ``csrc/attention_common.cuh``: from the first
  valid key's tile to the diagonal, or every tile when the query tile holds a row with no
  valid key).
- Forward: one pass over the walk with an online softmax (running max m from finfo.min, the sum
  l and the output rescaled by exp(m_old - m), divided by l at the end).
- Backward: kernel 1 walks the key tiles for m, s = sum exp(l - m) and t = sum exp(l - m) dW,
  r = t / s, then W = exp(l - m) (1 / s), dL = W (dW - r) and dQ = dL K, and writes W and dL of
  the pairs on and below the diagonal to a scratch indexed by the triangle, and each row's r and
  w0 = exp(finfo.min - m) / s; kernel 2 walks the query tiles meeting each key tile
  (``query_tiles``) for dV = W^T G and dK = dL^T Q, from the scratch on and below the diagonal
  and recomputed from w0 and r above it.
"""

import functools
import inspect
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_timesfm_tpu.ops.attention import fused_causal_attention as j_fused
from multimodal_timesfm_tpu.ops.qkv_attention import fused_qkv_causal_attention as j_fused_qkv
from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops import attention as tattn
from tests.test_torch_tf32_model import COMMON, CSRC, banks, const, mma3

HEADS, DIM, BATCH = 2, 80, 3
KERNEL_TOL = chip_smoke.KERNEL_TOL[torch.float32]
BWD_TOL = chip_smoke.BWD_TOL[torch.float32]
FMAX = torch.finfo(torch.float32).max

_HEADER = (CSRC / "attention_tf32.cuh").read_text()
_FWD = (CSRC / "attention_fwd_tf32.cu").read_text()
_BWD = (CSRC / "attention_bwd_tf32.cu").read_text()
ONE_TILE_TO = const("kOneTileTo", _HEADER)
TILE = const("kTile", _HEADER)
LD = const("kLd", _HEADER.replace("kD + 4", str(const("kD", _HEADER) + 4)))
SCRATCH_FLOATS = 1 << int(re.search(r"constexpr long long kScratchFloats = 1LL << (\d+);", _BWD).group(1))


def tile_rows(seq: int) -> int:
    """Query and key rows a tile of the route at S (``tile_rows`` in attention_tf32.cuh)."""
    return -(-seq // 16) * 16 if seq <= ONE_TILE_TO else TILE


def item_floats(seq: int) -> int:
    """Scratch of one work item (``item_floats``): W and dL of the triangle's tile pairs, and
    the rows' w0 and r."""
    kt = tile_rows(seq)
    nt = -(-seq // kt)
    return nt * (nt + 1) * kt * kt + 2 * seq


def chunk_items(batch: int, seq: int, heads: int) -> int:
    """Work items a chunk of the backward (``chunk_items``)."""
    n = batch * heads
    most = min(n, max(1, SCRATCH_FLOATS // item_floats(seq)))
    chunks = -(-n // most)
    return -(-n // chunks)


# ------------------------------------------------------------------ the walks


def first_valid(valid_row: torch.Tensor, limit: int) -> int:
    """The first valid key below ``limit``, or ``limit`` (``first_valid``)."""
    hits = torch.nonzero(valid_row[:limit]).flatten()
    return int(hits[0]) if len(hits) else limit


def key_tiles(q0: int, qlast: int, f: int, seq: int, kt: int) -> list[int]:
    """The key tiles a query tile [q0, qlast] visits (``key_tiles``)."""
    if q0 < f:
        return list(range(-(-seq // kt)))
    return list(range(f // kt, qlast // kt + 1))


def query_tiles(k0: int, klast: int, f: int, seq: int, bq: int) -> list[int]:
    """The query tiles a key tile [k0, klast] meets, in the kernel's order (``query_tiles``)."""
    nq = -(-seq // bq)
    a = min(-(-f // bq), nq)
    b = max(a, k0 // bq)
    count = a + (nq - b if klast >= f else 0)
    return [i if i < a else b + (i - a) for i in range(count)]


# ------------------------------------------------------------------ the model


def _mask(sc, q0, k0, valid_keys):
    """finfo.min where the key is after the row or not valid (keys past S are not in the tile)."""
    rows = torch.arange(q0, q0 + sc.shape[-2])[:, None]
    cols = torch.arange(k0, k0 + sc.shape[-1])[None, :]
    return torch.where((cols <= rows) & valid_keys[None, :], sc, torch.tensor(-FMAX))


def _tile(x, b, t0, kt):
    """Rows [t0, t0 + kt) of batch row b of a (B, S, H, D) tensor as (H, rows, D)."""
    return x[b, t0:t0 + kt].transpose(0, 1).float()


def tf32_forward(q, k, v, valid, terms=3):
    """The forward on the route in its order: (B, S, H, D) fp32."""
    batch, seq = q.shape[:2]
    kt = tile_rows(seq)
    out = torch.zeros(q.shape)
    for b in range(batch):
        for q0 in range(0, seq, kt):
            qlast = min(q0 + kt, seq) - 1
            qq = _tile(q, b, q0, kt)
            m = torch.full(qq.shape[:2], -FMAX)
            l = torch.zeros(qq.shape[:2])
            o = torch.zeros(qq.shape)
            for t in key_tiles(q0, qlast, first_valid(valid[b], qlast + 1), seq, kt):
                k0 = t * kt
                kk, vv = _tile(k, b, k0, kt), _tile(v, b, k0, kt)
                sc = mma3(torch.zeros(HEADS, qq.shape[1], kk.shape[1]), qq, kk.transpose(-1, -2), terms)
                sc = _mask(sc, q0, k0, valid[b, k0:k0 + kt])
                nm = torch.maximum(m, sc.amax(-1))
                scale = torch.exp(m - nm)
                p = torch.exp(sc - nm[..., None])
                l = l * scale + p.sum(-1)
                o = mma3(o * scale[..., None], p, vv, terms)
                m = nm
            out[b, q0:q0 + kt] = (o * (1 / l)[..., None]).transpose(0, 1)
    return out


def tf32_backward(q, k, v, valid, g, terms=3):
    """The backward on the route in its order: (dq, dk, dv), each (B, S, H, D) fp32. Kernel 2's
    lookups in kernel 1's scratch raise if its walk meets a pair on or below the diagonal that
    kernel 1 did not write."""
    batch, seq = q.shape[:2]
    kt = tile_rows(seq)
    nt = -(-seq // kt)
    dq, dk, dv = (torch.zeros(q.shape) for _ in range(3))
    scratch = {}
    w0 = torch.zeros(batch, HEADS, seq)
    rs = torch.zeros(batch, HEADS, seq)
    for b in range(batch):  # kernel 1
        for qt in range(nt):
            q0 = qt * kt
            qlast = min(q0 + kt, seq) - 1
            walk = key_tiles(q0, qlast, first_valid(valid[b], qlast + 1), seq, kt)
            qq, gg = _tile(q, b, q0, kt), _tile(g, b, q0, kt)
            m = torch.full(qq.shape[:2], -FMAX)
            s = torch.zeros(qq.shape[:2])
            t_ = torch.zeros(qq.shape[:2])
            tiles = {}
            for t in walk:
                k0 = t * kt
                kk, vv = _tile(k, b, k0, kt), _tile(v, b, k0, kt)
                dw = mma3(torch.zeros(HEADS, qq.shape[1], kk.shape[1]), gg, vv.transpose(-1, -2), terms)
                sc = mma3(torch.zeros(HEADS, qq.shape[1], kk.shape[1]), qq, kk.transpose(-1, -2), terms)
                sc = _mask(sc, q0, k0, valid[b, k0:k0 + kt])
                nm = torch.maximum(m, sc.amax(-1))
                scale = torch.exp(m - nm)
                e = torch.exp(sc - nm[..., None])
                s = s * scale + e.sum(-1)
                t_ = t_ * scale + (e * dw).sum(-1)
                m = nm
                tiles[t] = (sc, dw, kk)
            r = t_ / s
            inv = 1 / s
            w0[b, :, q0:q0 + kt] = torch.exp(-FMAX - m) * inv
            rs[b, :, q0:q0 + kt] = r
            acc = torch.zeros(qq.shape)
            for t in walk:
                sc, dw, kk = tiles[t]
                w = torch.exp(sc - m[..., None]) * inv[..., None]
                dl = w * (dw - r[..., None])
                if t <= qt:
                    scratch[(b, qt, t)] = (w, dl)
                acc = mma3(acc, dl, kk, terms)
            dq[b, q0:q0 + kt] = acc.transpose(0, 1)
    for b in range(batch):  # kernel 2
        f = first_valid(valid[b], seq)
        for t in range(nt):
            k0 = t * kt
            klast = min(k0 + kt, seq) - 1
            vv = _tile(v, b, k0, kt)
            adk = torch.zeros(vv.shape)
            adv = torch.zeros(vv.shape)
            for qt in query_tiles(k0, klast, f, seq, kt):
                q0 = qt * kt
                qq, gg = _tile(q, b, q0, kt), _tile(g, b, q0, kt)
                if qt >= t:
                    w, dl = scratch[(b, qt, t)]
                    adv = mma3(adv, w.transpose(-1, -2), gg, terms)
                    adk = mma3(adk, dl.transpose(-1, -2), qq, terms)
                else:  # above the diagonal: recomputed from the rows' w0 and r
                    rows = slice(q0, q0 + qq.shape[1])
                    dwt = mma3(torch.zeros(HEADS, vv.shape[1], qq.shape[1]), vv, gg.transpose(-1, -2), terms)
                    wt = w0[b, :, rows][:, None, :].expand_as(dwt)
                    dlt = wt * (dwt - rs[b, :, rows][:, None, :])
                    adv = mma3(adv, wt, gg, terms)
                    adk = mma3(adk, dlt, qq, terms)
            dk[b, k0:k0 + kt] = adk.transpose(0, 1)
            dv[b, k0:k0 + kt] = adv.transpose(0, 1)
    return dq, dk, dv


# ------------------------------------------------------------------- inputs


def _valid(rng, seq, kind):
    """(B, S) key masks: "padded" left pads in [0, S/2) (row 0 unpadded); "deep" pads past a
    whole tile, and a row whose one valid key is its last; "holes" left-padded, then keys
    invalid with probability 0.3 after the first valid one, and a row with no valid key."""
    ar = np.arange(seq)[None, :]
    pads = rng.integers(0, seq // 2, size=BATCH)
    pads[0] = 0
    valid = ar >= pads[:, None]
    if kind == "deep":
        pads = rng.integers(min(TILE, seq - 1), seq, size=BATCH)
        pads[0] = seq - 1
        valid = ar >= pads[:, None]
    elif kind == "holes":
        first = valid.argmax(axis=1)
        valid &= (rng.random((BATCH, seq)) >= 0.3) | (ar == first[:, None])
        valid[-1] = False
    return valid


def _case(seq, kind, zero_g=False):
    """fp32 (B, S, 3 H D) qkv (q scaled by D^-1/2; "large": q times 4, logits of tens), the key
    mask and a random cotangent on every row (with ``zero_g``: zero on the rows that see no
    key, as on the model path)."""
    rng = np.random.default_rng(seq + len(kind))
    qkv = rng.normal(size=(BATCH, seq, 3 * HEADS * DIM)).astype(np.float32)
    qkv[..., : HEADS * DIM] /= np.sqrt(DIM) / (4 if kind == "large" else 1)
    valid = _valid(rng, seq, "padded" if kind == "large" else kind)
    g = rng.normal(size=(BATCH, seq, HEADS * DIM)).astype(np.float32)
    if zero_g:
        g *= _sees_a_key(valid)[..., None]
    return qkv, valid, g


def _heads(qkv):
    return tuple(torch.from_numpy(x).unflatten(-1, (HEADS, DIM)) for x in np.split(qkv, 3, axis=-1))


@functools.cache
def _jax(seq, kind, zero_g=False):
    """JAX's forward and VJP at the case, as numpy arrays: B1's fused-qkv kernel below 256 tokens
    (its TPU bounds), B2's whole-sequence kernel from 256."""
    qkv, valid, g = _case(seq, kind, zero_g)
    if seq < 256:
        out, vjp = jax.vjp(lambda t: j_fused_qkv(t, jnp.asarray(valid), HEADS, DIM, True), jnp.asarray(qkv))
        (dqkv,) = vjp(jnp.asarray(g))
        return np.asarray(out).reshape(BATCH, seq, HEADS, DIM), np.split(np.asarray(dqkv).reshape(
            BATCH, seq, 3 * HEADS, DIM), 3, axis=2)
    q, k, v = (jnp.asarray(x.numpy()) for x in _heads(qkv))
    out, vjp = jax.vjp(lambda a, b, c: j_fused(a, b, c, jnp.asarray(valid), True), q, k, v)
    grads = vjp(jnp.asarray(g.reshape(BATCH, seq, HEADS, DIM)))
    return np.asarray(out), [np.asarray(x) for x in grads]


@functools.cache
def _model(seq, kind, terms=3, zero_g=False):
    qkv, valid, g = _case(seq, kind, zero_g)
    q, k, v = _heads(qkv)
    valid_t = torch.from_numpy(valid)
    gg = torch.from_numpy(g).unflatten(-1, (HEADS, DIM))
    return tf32_forward(q, k, v, valid_t, terms), tf32_backward(q, k, v, valid_t, gg, terms)


def _excess(out, ref, tol, rows=None) -> float:
    """max(|out - ref| - atol - rtol |ref|) over the (B, S) ``rows`` (all by default): <= 0
    within the tolerance."""
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    ex = np.abs(out - ref) - tol[0] - tol[1] * np.abs(ref)
    return float((ex if rows is None else ex[rows]).max())


def _sees_a_key(valid):
    """(B, S) rows with a valid key at or before them: JAX's fused-qkv kernel packs batch rows
    into one tile, so a row with none gets uniform weights over the tile, not over its S keys
    (the port's contract, and JAX's whole-sequence kernel's)."""
    first = np.where(valid.any(axis=1), valid.argmax(axis=1), valid.shape[1])
    return np.arange(valid.shape[1])[None, :] >= first[:, None]


CASES = [(8, "padded"), (16, "padded"), (16, "holes"), (64, "padded"), (64, "holes"), (300, "padded"),
         (300, "deep"), (300, "holes"), (300, "large")]


# -------------------------------------------------------------------- tests


@pytest.mark.parametrize("seq,kind", CASES)
def test_forward_matches_jax(seq, kind):
    """B1 lengths (8, 16, 64: one tile of 16, 16 and 64 rows) against JAX's fused-qkv kernel on
    every row that sees a key; 300 (five 64-row tiles, the last ragged: 44 rows) against JAX's
    whole-sequence kernel on every row, rows with no valid key included; and the model against
    the plain version (the card's check) on every row."""
    qkv, valid, _ = _case(seq, kind)
    out = _model(seq, kind)[0]
    ref = _jax(seq, kind)[0]
    rows = _sees_a_key(valid) if seq < 256 else None
    assert _excess(out, ref, KERNEL_TOL, rows) <= 0
    plain = tattn.plain_causal_attention(*_heads(qkv), torch.from_numpy(valid))
    assert _excess(out, plain, KERNEL_TOL) <= 0


@pytest.mark.parametrize("seq,kind", CASES)
def test_backward_matches_jax(seq, kind):
    """dq, dk and dv at the same cases, a random cotangent on every row, against the plain
    version (the card's check) and JAX's VJP on every element: "deep" and "holes" at 300 tokens
    send query tiles holding rows with no valid key over every key tile, so kernel 2 recomputes
    the pairs above the diagonal. Below 256 tokens JAX's fused-qkv kernel packs batch rows into
    one tile, and a row that sees no key spreads its weights over the other rows' keys: there
    dq is held to JAX on the rows that see a key, and the whole backward again with the
    cotangent zero on the rows that see none (the model path's)."""
    qkv, valid, g = _case(seq, kind)
    outs = _model(seq, kind)[1]
    refs = _jax(seq, kind)[1]
    plain = tattn.plain_attention_bwd(*_heads(qkv), torch.from_numpy(valid),
                                      torch.from_numpy(g).unflatten(-1, (HEADS, DIM)))
    for out, ref, p in zip(outs, refs, plain):
        assert _excess(out, p, BWD_TOL) <= 0
        if seq >= 256:
            assert _excess(out, ref, BWD_TOL) <= 0
    if seq < 256:
        assert _excess(outs[0], refs[0], BWD_TOL, _sees_a_key(valid)) <= 0
        for out, ref in zip(_model(seq, kind, zero_g=True)[1], _jax(seq, kind, zero_g=True)[1]):
            assert _excess(out, ref, BWD_TOL) <= 0


@pytest.mark.parametrize("seq,kind", [(64, "padded"), (300, "large")])
def test_one_tf32_product_misses_the_fp32_tolerance(seq, kind):
    """One TF32 product per pair (hi hi only: operands rounded to 2^-11) leaves the forward
    outside KERNEL_TOL and the backward outside BWD_TOL of the plain version: hence three."""
    qkv, valid, g = _case(seq, kind)
    fwd, bwd = _model(seq, kind, terms=1)
    q, k, v = _heads(qkv)
    plain = tattn.plain_causal_attention(q, k, v, torch.from_numpy(valid))
    plain_b = tattn.plain_attention_bwd(q, k, v, torch.from_numpy(valid),
                                        torch.from_numpy(g).unflatten(-1, (HEADS, DIM)))
    assert _excess(fwd, plain, KERNEL_TOL) > 0
    assert max(_excess(o, p, BWD_TOL) for o, p in zip(bwd, plain_b)) > 0


def test_scratch_index_follows_the_triangle_and_the_walk():
    """Kernel 1 writes W and dL only for pairs on and below the diagonal, each inside the
    triangle's index; kernel 2 reads every such pair its walk meets (the model's dict lookups
    would raise otherwise), and meets pairs above the diagonal only in query tiles holding a row
    with no valid key: every key tile, when a batch row has none."""
    seq = 300
    valid = _case(seq, "holes")[1]
    kt = tile_rows(seq)
    nt = -(-seq // kt)
    for b in range(BATCH):
        f = first_valid(torch.from_numpy(valid[b]), seq)
        written = set()
        for qt in range(nt):
            q0, qlast = qt * kt, min(qt * kt + kt, seq) - 1
            walk = key_tiles(q0, qlast, first_valid(torch.from_numpy(valid[b]), qlast + 1), seq, kt)
            assert all(t <= qt for t in walk) or q0 < f
            written |= {(qt, t) for t in walk if t <= qt}
            assert all(0 <= qt * (qt + 1) // 2 + t < nt * (nt + 1) // 2 for t in walk if t <= qt)
        read = set()
        above = set()
        for t in range(nt):
            for qt in query_tiles(t * kt, min(t * kt + kt, seq) - 1, f, seq, kt):
                (read if qt >= t else above).add((qt, t))
        assert read <= written
        assert all(qt * kt < f for qt, _ in above)
        if f == seq:  # the row with no valid key: every pair, half of them above the diagonal
            assert len(read) + len(above) == nt * nt and len(above) == nt * (nt - 1) // 2


@pytest.mark.parametrize("batch,seq,heads", [(16, 512, 16), (2, 2100, 16), (256, 16, 16), (64, 64, 16),
                                             (8, 2100, 16), (1, 16320, 16)])
def test_scratch_is_the_triangle_in_chunks(batch, seq, heads):
    """The backward's scratch (``tf32_bwd_scratch``): one chunk of work items (batch row, head),
    each the triangle's W and dL tiles and 2 S floats of row statistics, within 1 GiB: 303 MB at
    16 x 512 x 16 and 589 MB at 2 x 2,100 x 16 (about half of B H S^2 8 bytes), one chunk each;
    8 x 2,100 x 16 in three chunks. Past S = 16,320 one work item passes the budget and the rule
    keeps fp32 on the CUDA cores."""
    assert "return chunk_items(B, S, H) * item_floats(S);" in _BWD
    assert "return nt * (nt + 1) * KT * KT + 2LL * S;" in _BWD
    assert SCRATCH_FLOATS * 4 == 1 << 30
    items = chunk_items(batch, seq, heads)
    chunks = -(-batch * heads // items)
    mb = items * item_floats(seq) * 4 / 1e6
    assert mb <= SCRATCH_FLOATS * 4 / 1e6
    want = {(16, 512, 16): (1, 303), (2, 2100, 16): (1, 589), (8, 2100, 16): (3, None)}
    if (batch, seq, heads) in want:
        n, size = want[(batch, seq, heads)]
        assert chunks == n and (size is None or round(mb) == size)
        if size is not None:
            assert 0.5 < mb / (batch * heads * seq * seq * 8 / 1e6) < 0.6
    assert item_floats(16320) <= SCRATCH_FLOATS < item_floats(16321)
    assert "item_floats(S) <= kScratchFloats" in re.search(r"int tf32_bwd_takes\(.*?\n}\n", _BWD, re.S).group(0)


def test_tiles_strides_and_borders_read_from_the_sources():
    """The tile rule (one tile of S padded to 16 up to 80 tokens, else 64 rows), the row stride
    of a shared tile (84 floats at head_dim 80), the route's rule (fp32 at head_dim 80 with no
    border of its own: the dispatch asks route 5's rule first, which takes S from 128; the
    backward up to the budget's border; never under the route override 3, "cuda cores") and
    the dispatch: the CUDA-core route where its rule or layout does not hold."""
    assert (const("kD", _HEADER), ONE_TILE_TO, TILE, LD) == (80, 80, 64, 84)
    assert [tile_rows(s) for s in (8, 16, 17, 64, 65, 80, 81, 300, 2100)] == [16, 16, 32, 64, 80, 80, 64, 64, 64]
    assert "kFwdFrom" not in _FWD and "kBwdFrom" not in _BWD
    assert 'int tf32_fwd_takes(int D) { return D == kD && mtt_attention_route_override() != 3; }' in _FWD
    assert "return D == kD && item_floats(S) <= kScratchFloats && mtt_attention_route_override() != 3;" in _BWD
    fwd_c = (CSRC / "attention_fwd.cu").read_text()
    bwd_c = (CSRC / "attention_bwd.cu").read_text()
    assert "if (tf32_fwd_takes(D) && tf32_fwd_layout(q, k, v, out, ld_in, ld_out))" in fwd_c
    assert "if (route < 0 || route > 5) return (int)cudaErrorInvalidValue;" in fwd_c
    assert "tf32_bwd_layout(q, k, v, g, dq, dk, dv, ld_in, ld_g, ld_out))\n    return tf32_attention_bwd(" in bwd_c
    assert _kernels.ROUTE_NAMES["cuda cores"] == 3 and "3xTF32" in _kernels._ROUTES[4]
    short = (CSRC / "attention_bwd_short_hopper.cu").read_text()
    assert "force != 1 && force != 2" in short  # the fp32 override leaves bf16 to the rule


@pytest.mark.parametrize("ld", [68, LD])
def test_every_fragment_load_meets_32_banks(ld):
    """At the Chronos route's row stride (68) and the causal route's (84), ldmatrix's eight
    16-byte rows and the scalar loads of both patterns (8t + g, 4g + t) meet 32 distinct banks."""
    for pattern, hit in banks(ld).items():
        assert sorted(hit) == list(range(32)), pattern
    assert sorted(banks(80)["ldmatrix"]) != list(range(32))  # an unpadded row of 80 floats would not


def test_products_are_mma_sync_tf32_in_the_kernels():
    """The route's products are tf32_common.cuh's mma.sync m16n8k8 TF32 templates, instantiated at
    head_dim 80 in the kernels' own bodies; no library call."""
    assert "template <int D, int LD, int NT>" in COMMON and "mma.sync.aligned.m16n8k8.row.col.f32.tf32" in COMMON
    for name, src in (("attention_fwd_tf32.cu", _FWD), ("attention_bwd_tf32.cu", _BWD)):
        assert CSRC / name in _kernels.SOURCES
        assert '#include "attention_tf32.cuh"' in src and "xyt<kD, kLd, NT>(" in src
        assert not re.search(r"cublas|cudnn|#include <torch|#include <ATen", src, re.I)
    assert "pty<kD, kLd, KT, LDW>(" in _BWD and "py<kD, kLd, NT>(dka, dlt, Qt, lane);" in _BWD


def test_chip_smoke_names_the_route_its_gate_and_its_launches():
    """chip_smoke.py gives the route's rows the 3xTF32 bound, times it against route 5 at S =
    16-2,100 ([gate] causal fp32 lines, under --kernel-times), requires HMMA.1688.F32.TF32 in
    its kernels, and splits every causal kernel's launches by route."""
    assert set(chip_smoke.CAUSAL_TF32_FAMILIES) == {"attention_fwd_tf32_kernel", "attention_bwd_dq_tf32_kernel",
                                                    "attention_bwd_dkdv_tf32_kernel"}
    for family in chip_smoke.CAUSAL_TF32_FAMILIES:
        assert f"    {family}(" in _FWD + _BWD
    assert "TF32_FAMILIES + CAUSAL_TF32_FAMILIES" in inspect.getsource(chip_smoke.sass_mma_report)
    assert chip_smoke.B1_ROUTES[4] == "tf32"
    assert set(chip_smoke.ROUTED_KEYS) >= {"B1f", "B1b", "B2f", "B2b", "B3f", "B3b"}
    assert chip_smoke.CAUSAL_F32_BORDER_LENGTHS == (16, 32, 64, 128, 192, 256, 512, 1024, 2100)
    assert "causal_f32_borders" in inspect.getsource(chip_smoke.main).split("def phase(")[0]
    bound, by = chip_smoke.attention_bound(2, 2100, 16, 80, torch.ones(2, 2100, dtype=torch.bool), torch.float32,
                                           three_tf32=True)
    flops = 4 * 80 * 16 * 2 * 2100 * 2101 // 2
    assert by == "operations" and math.isclose(bound, 3 * flops / 495e12 * 1e3)
    bound_b, _ = chip_smoke.backward_bound(2, 2100, 16, 80, torch.ones(2, 2100, dtype=torch.bool), torch.float32,
                                           three_tf32=True)
    assert math.isclose(bound_b, 2.5 * bound)
