"""Route 7 of B4f and B4b (fp32, head_dim 64, 3xTF32 on wgmma fed by TMA), against the JAX package.

Route 7 (``csrc/chronos_attention_tf32_hopper.cu``, ``csrc/chronos_attention_bwd_tf32_hopper.cu``,
their pieces in ``csrc/chronos_tf32_hopper.cuh``) takes the Chronos fp32 calls past route 6's
borders. It runs only on the card; ``chip_smoke.py`` holds it against the plain versions there. Here
the model below repeats, in PyTorch on the CPU, what its kernels compute and in which order, and is
held against JAX's ``fused_chronos_attention`` in fp32 (the Pallas kernel in interpret mode, as the
JAX package's own tests run it) and its VJP, within ``KERNEL_TOL`` and ``BWD_TOL`` on every element:

- The products: ``tests/test_torch_tf32_model.py``'s ``wgmma3`` (each operand split by truncation, hi
  = trunc(x), lo = tf32(x - hi); lo hi, hi lo, hi hi per k-step of 8). A walked tile is 32 rows, a
  multiple of 8, so a walk's k-steps are one product's over all the keys (or queries).
- Forward: one pass over the 32-key tiles, the logits Q K^T plus the bias folded with the segment
  mask (finfo.min across segments, one add), the online softmax (running max from finfo.min, the sum
  and the output rescaled), the output divided by the sum at the end.
- Backward: a statistics kernel (m, 1 / s and r = t / s per row from S = Q K^T and dW = G V^T over
  the key tiles), a dQ kernel (W = exp(l - m) / s, dL = W (dW - r), dQ += dL K, W and dL to a
  scratch), a dK/dV kernel (dV += W^T G, dK += dL^T Q over the 32-query tiles, W^T and dL^T read
  from the scratch) and, with dbias, dL summed over the batch rows in order, chunk after chunk.
"""

import inspect
import re

import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops import chronos_attention as tca
from multimodal_timesfm_torch.ops.attention import NEG_INF
from tests.test_torch_port_chronos_tf32 import (
    BATCH,
    BWD_TOL,
    DIM,
    HEADS,
    KERNEL_TOL,
    _excess,
    _heads,
    _jax,
    _torch_case,
    _zeros,
)
from tests.test_torch_tf32_model import CSRC, const, tf32_trunc, wgmma3

HEADER = (CSRC / "chronos_tf32_hopper.cuh").read_text()
FWD = (CSRC / "chronos_attention_tf32_hopper.cu").read_text()
BWD = (CSRC / "chronos_attention_bwd_tf32_hopper.cu").read_text()
RES = const("kRes", HEADER)  # rows of a resident tile
STR = const("kStr", HEADER)  # rows of a walked tile
FWD_FROM = const("kFwdFrom", FWD)
BWD_FROM = const("kBwdFrom", BWD)
SCRATCH_FLOATS = 1 << int(re.search(r"constexpr long long kScratchFloats = 1LL << (\d+);", BWD).group(1))
SMEM_LIMIT = 232448  # a block's dynamic shared memory on an H100


# ------------------------------------------------------------------ the model


def _logits(q, k, seg, bias, k0, k1, terms, rows=None):
    """Q K^T over keys [k0, k1) plus the folded bias: the bias where the segments match, finfo.min
    across them (one add, as the kernels' fold_mask and add_bias). ``rows``: each query row's row
    of the bias and the ids (the kernels clamp a row past S to the last one)."""
    rseg, rbias = (seg, bias) if rows is None else (seg[:, rows], bias[:, rows])
    same = (rseg[:, :, None] == seg[:, None, k0:k1])[:, None]
    sc = wgmma3(_zeros(*q.shape[:3], k1 - k0), q, k[:, :, k0:k1].transpose(-1, -2), terms)
    return sc + torch.where(same, rbias[None, :, :, k0:k1], torch.tensor(NEG_INF))


def w_forward(qkv, seg, bias, terms=3):
    """B4f on route 7 in its order: (B, S, H*D) fp32."""
    q, k, v = _heads(qkv)
    batch, heads, seq, _ = q.shape
    m = torch.full((batch, heads, seq), NEG_INF)
    s = _zeros(batch, heads, seq)
    o = _zeros(batch, heads, seq, DIM)
    for k0 in range(0, seq, STR):
        k1 = min(seq, k0 + STR)
        sc = _logits(q, k, seg, bias, k0, k1, terms)
        nm = torch.maximum(m, sc.amax(-1))
        scale = torch.exp(m - nm)
        p = torch.exp(sc - nm[..., None])
        s = s * scale + p.sum(-1)
        o = wgmma3(o * scale[..., None], p, v[:, :, k0:k1], terms)
        m = nm
    return (o * (1 / s)[..., None]).transpose(1, 2).flatten(-2)


def dbias_sum(dl, rows):
    """dL (B, H, S, S) summed over the batch in order, chunks of ``rows`` batch rows, each chunk's
    rows added to the sum of the chunks before it (the sum kernel's ``carry``)."""
    dbias = None
    for b0 in range(0, dl.shape[0], rows):
        acc = dbias if dbias is not None else _zeros(*dl.shape[1:])
        for b in range(b0, min(dl.shape[0], b0 + rows)):
            acc = acc + dl[b]
        dbias = acc
    return dbias


def _pad_rows(x, rows):
    """x (B, H, S, ...) with zero rows up to ``rows`` along S (TMA's fill past S)."""
    return torch.cat([x, _zeros(*x.shape[:2], rows - x.shape[2], *x.shape[3:])], dim=2)


def w_backward(qkv, seg, bias, g, terms=3, rows=None, select=True):
    """B4b on route 7 in its order: dqkv (B, S, 3*H*D) and dbias (H, S, S), fp32; ``rows``: batch
    rows a chunk of the scratch (all of them by default); ``select``: W and dL set to 0 on the
    query rows past S that the dK/dV kernel reads (without it, the dq kernel before that fix)."""
    q, k, v, gg = _heads(qkv, g)
    batch, heads, seq, _ = q.shape
    # Kernel 1: the statistics, online over the key tiles. The products run over the rows of whole
    # 32-row query tiles, which the dK/dV kernel reads from the scratch: a row past S has zero q
    # and g, the last row's bias and id, and statistics stored as zeros.
    seq_p = -(-seq // STR) * STR
    idx = torch.arange(seq_p).clamp(max=seq - 1)
    live = (torch.arange(seq_p) < seq)[:, None]
    qp, gp = _pad_rows(q, seq_p), _pad_rows(gg, seq_p)
    m = torch.full((batch, heads, seq), NEG_INF)
    s = _zeros(batch, heads, seq)
    t = _zeros(batch, heads, seq)
    tiles = []
    for k0 in range(0, seq, STR):
        k1 = min(seq, k0 + STR)
        sc = _logits(qp, k, seg, bias, k0, k1, terms, idx)
        dw = wgmma3(_zeros(batch, heads, seq_p, k1 - k0), gp, v[:, :, k0:k1].transpose(-1, -2), terms)
        tiles.append((sc, dw))
        sc, dw = sc[:, :, :seq], dw[:, :, :seq]
        nm = torch.maximum(m, sc.amax(-1))
        scale = torch.exp(m - nm)
        e = torch.exp(sc - nm[..., None])
        s = s * scale + e.sum(-1)
        t = t * scale + (e * dw).sum(-1)
        m = nm
    # Kernel 2: W and dL a tile at a time (the same products again), dQ += dL K.
    mp, inv, r = (_pad_rows(x, seq_p) for x in (m, 1 / s, t / s))
    w, dl = [], []
    for sc, dw in tiles:
        wt = torch.exp(sc - mp[..., None]) * inv[..., None]
        dlt = wt * (dw - r[..., None])
        w.append(torch.where(live, wt, 0.0) if select else wt)
        dl.append(torch.where(live, dlt, 0.0) if select else dlt)
    w, dl = torch.cat(w, dim=-1), torch.cat(dl, dim=-1)
    dq = wgmma3(_zeros(batch, heads, seq, DIM), dl[:, :, :seq], k, terms)
    # Kernel 3: dV += W^T G and dK += dL^T Q over the 32-query tiles, from the scratch.
    dv = wgmma3(_zeros(batch, heads, seq, DIM), w.transpose(-1, -2), gp, terms)
    dk = wgmma3(_zeros(batch, heads, seq, DIM), dl.transpose(-1, -2), qp, terms)
    dqkv = torch.cat([d.transpose(1, 2).flatten(-2) for d in (dq, dk, dv)], dim=-1)
    return dqkv, dbias_sum(dl[:, :, :seq], rows or batch)


# -------------------------------------------------------------------- tests


CASES = [(seq, "one") for seq in (81, 97, 113, 193, 577)]
CASES += [(81, "padded"), (113, "padded"), (577, "padded"), (193, "large"), (97, "sixteen"), (577, "sixteen")]
CASES += [(81, "lastrow"), (577, "lastrow")]


@pytest.mark.parametrize("seq,kind", CASES)
def test_forward_matches_jax(seq, kind):
    """S = 81 to 577 (the lengths past route 6's borders, where chip_smoke.py checks route 7
    forced, to Chronos-2's serving at context 8192), one segment, three with padded tokens, logits of
    tens, sixteen segments, a last bias row past 88."""
    qkv, seg, bias, _ = _torch_case(seq, kind)
    out = w_forward(qkv, seg, bias)
    assert out.shape == (BATCH, seq, HEADS * DIM)
    assert _excess(out, _jax(seq, kind)[0], KERNEL_TOL) <= 0


@pytest.mark.parametrize("seq,kind", CASES)
def test_backward_matches_jax(seq, kind):
    """dqkv and dbias (the batch's two rows in two chunks of one); "sixteen" centres the cotangent
    over each segment's rows, so dV keeps only W's spread."""
    qkv, seg, bias, g = _torch_case(seq, kind)
    dqkv, dbias = w_backward(qkv, seg, bias, g, rows=1)
    _, ref_dqkv, ref_dbias = _jax(seq, kind)
    assert _excess(dqkv, ref_dqkv, BWD_TOL) <= 0
    assert _excess(dbias, ref_dbias, BWD_TOL) <= 0


@pytest.mark.parametrize("seq", [81, 577])
def test_rows_past_s_keep_dk_and_dv_finite(seq):
    """The dK/dV kernel reads W and dL of whole 32-row query tiles; the dq kernel's rows past S
    take the last row's bias with zero statistics, so a last bias row past 88 overflows exp there
    and 0 x inf carries NaN into dK and dV unless W and dL are set to 0 on those rows (C4)."""
    qkv, seg, bias, g = _torch_case(seq, "lastrow")
    assert seq % STR
    assert torch.isnan(w_backward(qkv, seg, bias, g, select=False)[0]).any()
    assert torch.isfinite(w_backward(qkv, seg, bias, g)[0]).all()
    assert "sc[c][e] = rows[r] < S ? w : 0.f;" in BWD and "dw[c][e] = rows[r] < S ? w * (dw[c][e] - tr[r]) : 0.f;" in BWD


def test_model_matches_the_plain_version():
    """The card holds the kernels to the plain versions: the model stays within the same
    tolerances of them, at 113 tokens with padded tokens."""
    qkv, seg, bias, g = _torch_case(113, "padded")
    plain = tca.plain_chronos_attention(qkv, seg, bias)
    ref_dqkv, ref_dbias = tca.plain_chronos_attention_bwd(qkv, seg, bias, g, True)
    dqkv, dbias = w_backward(qkv, seg, bias, g)
    assert _excess(w_forward(qkv, seg, bias), plain.numpy(), KERNEL_TOL) <= 0
    assert _excess(dqkv, ref_dqkv.numpy(), BWD_TOL) <= 0
    assert _excess(dbias, ref_dbias.numpy(), BWD_TOL) <= 0


@pytest.mark.parametrize("seq", [193, 577])
def test_one_tf32_product_misses_the_fp32_tolerance(seq):
    """One TF32 product per k-step (hi hi of truncated operands) leaves the forward outside
    KERNEL_TOL and dqkv outside BWD_TOL: hence three on this route too."""
    qkv, seg, bias, g = _torch_case(seq, "one")
    out, ref_dqkv, _ = _jax(seq, "one")
    assert _excess(w_forward(qkv, seg, bias, terms=1), out, KERNEL_TOL) > 0
    assert _excess(w_backward(qkv, seg, bias, g, terms=1)[0], ref_dqkv, BWD_TOL) > 0


def test_chunks_sum_dbias_in_batch_order():
    """The sum kernel runs once a chunk and starts each element from the chunks' sum before it: the
    same additions in the same order as one sum over the batch, so a chunked dbias is bit-equal to
    the whole one (and two launches to each other)."""
    dl = torch.from_numpy(np.random.default_rng(5).normal(size=(7, 2, 9, 9)).astype(np.float32)) * 1e3
    whole = dbias_sum(dl, 7)
    for rows in (1, 2, 3, 6):
        assert torch.equal(dbias_sum(dl, rows), whole)
    assert "float acc = carry ? dbias[e] : 0.f;" in BWD and "for (int b = 0; b < B; ++b) acc += p[b * step];" in BWD
    assert not re.search(r"atomic", re.sub(r"//[^\n]*", "", BWD + FWD + HEADER))


def test_tiles_transposes_and_product_order_follow_the_sources():
    """Head_dim 64 in two 32-column blocks of 128 bytes (128-byte swizzle: chunk c of row r at c ^ (r
    % 8)), eight k-steps; 64 resident rows, 32 walked; X^T's rows within each 8 stored 0, 2, 4, 6, 1,
    3, 5, 7 (an accumulator's thread holds a k-step's columns 2t as k = t and 2t + 1 as k = t + 4);
    each product lo hi, hi lo, hi hi a k-step; the split is route 5's (hi the value as it lies)."""
    assert (const("kD", HEADER), RES, STR) == (64, 64, 32)
    assert "return (c >> 5) * R * 128 + r * 128 + ((((cc >> 2) ^ (r & 7)) << 4) | ((cc & 3) << 2));" in HEADER
    rows_of = []
    for j in range(8):
        rows_of += [8 * (j >> 1) + (j & 1) + 2 * e for e in range(4)]
    assert rows_of[:8] == [0, 2, 4, 6, 1, 3, 5, 7] and sorted(rows_of) == list(range(32))
    assert HEADER.count("const int k0 = 8 * (j >> 1) + (j & 1);") == 2  # convert_t and convert_t4
    issue = re.search(r"void issue_abt3\(.*?\n}\n", HEADER, re.S).group(0)
    assert re.findall(r"wgmma_tf32_ss32\(acc, (.*)\);", issue) == [
        "nat_desc<kRes>(a_lo, kk), bh, kk > 0", "ah, nat_desc<kStr>(b_lo, kk), 1", "ah, bh, 1"]
    pb = re.search(r"void issue_pb3\(.*?\n}\n", HEADER, re.S).group(0)
    assert re.findall(r"wgmma_tf32_rs64\(out, (.*)\);", pb) == ["lo[kk], th", "hi[kk], t_desc(t_lo, kk)", "hi[kk], th"]
    assert "m64n64k8.f32.tf32.tf32" in HEADER and '#include "attention_tf32_hopper.cuh"' in HEADER
    assert "using tf32w::lo_bits;" in HEADER and "using tf32w::acc_frags;" in HEADER
    x = torch.from_numpy(np.random.default_rng(2).normal(size=1000).astype(np.float32))
    assert torch.equal(tf32_trunc(x).view(torch.int32) & 0x1FFF, torch.zeros(1000, dtype=torch.int32))


def _smem(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_shared_memory_sums_fit_a_block():
    """The forward's block (Q and its twin for two warpgroups, two raw V slots, four stages of K,
    K's twin and V^T hi and lo) and the backward's (the row kernels' Q, G and twins for two
    warpgroups with their stages and K^T slots; the dK/dV kernel's Q, G stages and Q^T, G^T slots)
    fit one block's 227 KB, as the sources compute them."""
    tile = lambda rows: rows * 64 * 4  # noqa: E731
    t_bytes = 64 * STR * 4
    consumers, stages, raw = _smem(FWD, "kConsumers"), _smem(FWD, "kStages"), _smem(FWD, "kRawV")
    fwd = 1024 + 2 * consumers * tile(RES) + raw * tile(STR) + stages * (2 * tile(STR) + 2 * t_bytes) + \
        8 * (2 + 3 * stages + 2 * raw)
    assert (consumers, stages, raw) == (2, 4, 2) and fwd <= SMEM_LIMIT
    assert "constexpr int kSmem = kAlign + kBars + 8 * (2 + 3 * kStages + 2 * kRawV);" in FWD
    consumers = _smem(BWD, "kConsumers")
    assert consumers == 2
    res = consumers * 4 * tile(RES)
    stats = 1024 + res + 3 * 4 * tile(STR) + 8 * (2 + 3 * 3)
    dq = 1024 + res + 2 * 4 * tile(STR) + 2 * 2 * t_bytes + 8 * (2 + 3 * 2 + 2)
    dkdv = 1024 + _smem(BWD, "kDkdvStages") * 2 * tile(STR) + _smem(BWD, "kDkdvSlots") * 4 * t_bytes + \
        8 * 2 * (_smem(BWD, "kDkdvStages") + _smem(BWD, "kDkdvSlots"))
    assert max(stats, dq, dkdv) <= SMEM_LIMIT
    assert "rows_stages(bool dq) { return dq ? 2 : 3; }" in BWD and "rows_tslots(bool dq) { return dq ? 2 : 0; }" in BWD


def _wd_row(seq, heads):
    return heads * -(-seq // RES) * -(-seq // STR) * RES * STR


def _chunk(batch, seq, heads):
    most = min(batch, max(1, SCRATCH_FLOATS // (2 * _wd_row(seq, heads))))
    chunks = -(-batch // most)
    return -(-batch // chunks)


@pytest.mark.parametrize("batch,seq,heads", [(16, 577, 12), (64, 193, 12), (32, 577, 12), (1, 8192, 12),
                                              (160, 577, 12), (3, 97, 2)])
def test_the_scratch_is_the_statistics_and_one_chunk_of_w_and_dl(batch, seq, heads):
    """The backward's scratch (``chronos_tf32w_scratch``): 3 floats a row of statistics, then W and
    dL of one chunk of batch rows in (64-row, 32-key) tile pairs, the chunk within 1 GiB unless one
    row is more (no length cap: a chunk is at least one row); 16 x 577 x 12 is one chunk of 598 MB
    (route 5 wrote 1.3 GB there), 32 x 577 two."""
    assert "return 3LL * B * H * ((S + kRes - 1) / kRes * kRes) + 2 * chunk_rows(B, S, H) * wd_row_floats(S, H);" in BWD
    assert "return (long long)H * ((S + kRes - 1) / kRes) * ((S + kStr - 1) / kStr) * kRes * kStr;" in BWD
    rows = _chunk(batch, seq, heads)
    assert 1 <= rows <= batch and 2 * rows * _wd_row(seq, heads) <= max(SCRATCH_FLOATS, 2 * _wd_row(seq, heads))
    if (batch, seq, heads) == (16, 577, 12):
        assert rows == 16 and round(2 * rows * _wd_row(seq, heads) * 4 / 1e6) == 598
    if (batch, seq, heads) == (32, 577, 12):
        assert rows == 16
    takes = re.search(r'int chronos_tf32w_takes\(int backward, int S, int D\) \{.*?\n}\n', FWD, re.S).group(0)
    assert "return force == 7 || S >= (backward ? chronos_tf32w_bwd_from() : kFwdFrom);" in takes
    dispatch = (CSRC / "chronos_attention_bwd.cu").read_text()
    assert ": p.route == 7              ? chronos_tf32w_scratch(B, S, H)" in dispatch


def test_dispatch_takes_route_6_then_7_then_5():
    """make_plan asks route 6, then route 7, then route 5 (then the CUDA cores) in fp32 at
    head_dim 64; route 7's borders are kFwdFrom / kBwdFrom, which the [gate] chronos fp32 wgmma
    lines set and ``_kernels.CHRONOS_TF32_WGMMA_FROM`` repeats; ``chronos_f32_route`` follows that
    rule; the override "tf32 wgmma" (7) forces route 7 at every S, "tf32 mma.sync" (5) and "cuda
    cores" (4) keep fp32 off it."""
    assert _kernels.CHRONOS_TF32_WGMMA_FROM == {"forward": FWD_FROM, "backward": BWD_FROM} == {
        "forward": 160, "backward": 385}
    common = (CSRC / "chronos_common.cuh").read_text()
    plan = common[common.index("inline Plan make_plan("):]
    order = [plan.index(x) for x in ("chronos_short_tf32_takes(S, D)", "chronos_tf32w_takes(backward ? 1 : 0, S, D)",
                                     "chronos_tf32_takes(D)")]
    assert order == sorted(order)
    assert "if (D != kD || force == 4 || force == 5) return 0;" in FWD
    assert _kernels.CHRONOS_ROUTE_NAMES["tf32 wgmma"] == 7 and _kernels._CHRONOS_ROUTES[7].startswith("fp32 3xTF32 wgmma")
    assert "if (route < 0 || route > 7 || route == 2) return (int)cudaErrorInvalidValue;" in (
        CSRC / "chronos_attention_hopper.cu").read_text()
    for backward, short_to in ((False, 112), (True, 80)):
        way = "backward" if backward else "forward"
        for seq in range(1, 1100):
            want = 6 if _kernels.CHRONOS_TF32_SHORT_FROM[way] <= seq <= short_to else \
                7 if seq >= _kernels.CHRONOS_TF32_WGMMA_FROM[way] else 5
            assert _kernels.chronos_f32_route(backward, seq, 64) == want
        assert _kernels.chronos_f32_route(backward, 577, 80) == 0
    assert {_kernels.chronos_f32_route(b, s, 64) for b, s in ((False, 193), (False, 577), (True, 577))} == {7}
    assert {_kernels.chronos_f32_route(b, s, 64) for b, s in ((False, 113), (True, 81), (True, 193))} == {5}
    fwd_c = (CSRC / "chronos_attention.cu").read_text()
    assert "if (route == 7) return chronos_tf32w_fwd(qkv, seg, bias, out, B, S, H, stream);" in fwd_c


def test_route_7_is_hand_written_wgmma_fed_by_tma():
    """Both files are sources of the library, include the route's header, load their tiles by TMA
    (fp32 boxes of 32 columns, 128-byte swizzle), take every product through issue_abt3 / issue_pb3,
    and call no library."""
    for name in ("chronos_attention_tf32_hopper.cu", "chronos_attention_bwd_tf32_hopper.cu"):
        assert CSRC / name in _kernels.SOURCES
        src = (CSRC / name).read_text()
        assert '#include "chronos_tf32_hopper.cuh"' in src and "load_tile<" in src and "issue_pb3(" in src
        code = re.sub(r"//[^\n]*", "", src)
        assert not re.search(r"cp_async|cublas|cudnn|scaled_dot_product|#include <torch|#include <ATen|jax", code,
                             re.I)
    assert "CU_TENSOR_MAP_DATA_TYPE_FLOAT32" in HEADER and "CU_TENSOR_MAP_SWIZZLE_128B" in HEADER
    assert "issue_abt3(" in FWD and BWD.count("issue_abt3(") == 2


def test_chip_smoke_gates_checks_and_counts_route_7():
    """chip_smoke.py checks route 7 forced at its lengths in the Chronos kernel phase, times it
    against routes 5 and 6 in ``[gate] chronos fp32 wgmma`` lines under --kernel-times only, requires
    HGMMA on TF32 operands and UTMALDG in its kernels and reports their ptxas lines, counts its
    main-path launches ("B4f tf32 wgmma", "B4b tf32 wgmma") and fails when one is 0, expects it on
    the fp32 serving and c8192 fine-tune paths, gives it rows in the kernels line, and times the fp32
    Chronos paths under --fp32-times."""
    assert chip_smoke.B4_ROUTES[7] == "tf32 wgmma"
    assert "tf32w_checks(gen)" in inspect.getsource(chip_smoke.chronos_kernel_phase)
    assert {81, 96, 97, 113, 128, 129, 193, 577, 1025} == set(chip_smoke.TF32W_LENGTHS)
    assert {6, 12} == {v[1] for v in chip_smoke.TF32W_VARIANTS} and any(v[0] % 2 for v in chip_smoke.TF32W_VARIANTS)
    main = inspect.getsource(chip_smoke.main)
    before, after = main.split("def phase(")
    assert "chronos_f32_wgmma_borders(args.seed)" in before and "chronos_f32_wgmma_borders" not in after
    assert chip_smoke.F32_WGMMA_BORDER_LENGTHS == (81, 97, 113, 128, 160, 193, 256, 385, 577, 1025)
    gate = inspect.getsource(chip_smoke.chronos_f32_wgmma_borders)
    assert all(x in gate for x in ('"tf32 mma.sync"', '"tf32 persistent"', '"tf32 wgmma"', "BORDER_MARGIN"))
    assert set(chip_smoke.TF32W_CHRONOS_FAMILIES) == {"chronos_fwd_tf32w_kernel", "chronos_bwd_rows_tf32w_kernel",
                                                      "chronos_bwd_dkdv_tf32w_kernel"}
    for family in chip_smoke.TF32W_CHRONOS_FAMILIES:
        assert f"    {family}(" in FWD + BWD
    assert "TF32W_FAMILIES + TF32W_CHRONOS_FAMILIES" in inspect.getsource(chip_smoke.sass_mma_report)
    assert 'idle += [f"{key} tf32 wgmma" for key, *_ in TF32W_CHRONOS_KERNELS' in main
    assert "tf32w_chronos_entries(rows, routes)" in main
    serving = inspect.getsource(chip_smoke.chronos_serving_phase)
    training = inspect.getsource(chip_smoke.chronos_training_phase)
    assert '"tf32 wgmma", dtype)' in serving and '"tf32 wgmma", dtype)' in training
    assert training.count('("chronos_mm_c8192", "multimodal", torch.float32') == 1
    assert training.count('("chronos_baseline_c8192", "baseline", torch.float32') == 1
    assert "chronos_fp32_times(seed, repeats, epochs)" in inspect.getsource(chip_smoke.fp32_times)
    log = ("ptxas info    : Compiling entry function '_Z24chronos_fwd_tf32w_kernelv' for 'sm_90a'\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n"
           "ptxas info    : (C7511) Potential Performance Loss: wgmma.mma_async instructions are serialized due "
           "to insufficient register resources for the wgmma pipeline in the function '_Z29chronos_bwd_dkdv_tf32w_kernelv'\n")
    lines = chip_smoke.ptxas_report(log)
    assert len(lines) == 2 and lines[0].startswith("route 7 ") and "C7511" in lines[1]
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.ptxas_report(log.replace("Used 168 registers", "8 bytes spill stores, 8 bytes spill loads"))
    shape = (16, 577, 12, 64)
    rows = {chip_smoke.row_key(key, shape, torch.float32): {"ms": 1.0 + i} for i, key in enumerate(("B4f", "B4b"))}
    entries = chip_smoke.tf32w_chronos_entries(rows, {"B4f tf32 wgmma": 352, "B4b tf32 wgmma": 96})
    assert [(e["name"], e["launches"], e["ms"]) for e in entries] == [
        ("fused_chronos_attention (3xTF32 wgmma route)", 352, 1.0),
        ("fused_chronos_attention_bwd (3xTF32 wgmma route)", 96, 2.0)]
    assert [e["source"].rsplit("/", 1)[1] for e in entries] == ["chronos_attention_tf32_hopper.cu",
                                                               "chronos_attention_bwd_tf32_hopper.cu"]
