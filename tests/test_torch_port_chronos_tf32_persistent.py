"""Route 6 of B4f and B4b (fp32, head_dim 64, short sequences), against the JAX package.

Route 6 (``csrc/chronos_attention_short_tf32.cu``, ``csrc/chronos_attention_bwd_short_tf32.cu``,
sharing ``csrc/chronos_tf32_short.cuh``) is route 4's persistent shape in fp32: blocks that own
one head and a range of batch rows, a producer warp feeding each row's q, k, v (and g) tiles by
TMA, every product 3xTF32 on ``mma.sync`` m16n8k8. It runs only on the card; ``chip_smoke.py``
holds it against the plain version there. Here its arithmetic is modelled on the CPU in its
order and held against JAX's ``fused_chronos_attention`` in fp32 (the Pallas kernel in
interpret mode, as the JAX package's own tests run it) and its VJP, within ``KERNEL_TOL`` and
``BWD_TOL`` in fp32:

- every operand splits as route 5 of the causal kernels splits it: hi = trunc(x), the value as it
  lies (the tensor cores read its 19 high bits), lo = tf32(x - hi); the lo twins of K and V are
  written once a row into shared memory, the other operands split as each warp reads them;
- the logits start from the bias, then take Q K^T per k-step of 8 over the head_dim (lo hi, hi
  lo, hi hi: ``tests/test_torch_tf32_model.py``'s ``wgmma3``); the segment mask at
  finfo(float32).min;
- the whole row is in registers: its exact max m and sum s, W = exp(l - m) (1 / s); the forward
  takes O = W V per k-step of 8 keys;
- the backward's phase A, two warps a 16-row block, each on half the keys: dW = G V^T, the row
  max and the sums s = sum e and sum e dW over both halves (e = exp(l - m)), W = e (1 / s), r =
  (sum e dW) / s, dL = W (dW - r); dQ = dL K from dL in the block's shared memory; phase B (W and
  dL from there): dV = W^T G and dK = dL^T Q over the SP = S rounded up to 16 query rows; dbias:
  each block's rows summed in batch order, then the blocks' partials in order.
"""

import functools
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_timesfm_tpu.ops.chronos_attention import fused_chronos_attention as j_chronos
from multimodal_timesfm_tpu.ops.chronos_attention import make_rowtile_bias
from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops import chronos_attention as tca
from multimodal_timesfm_torch.ops.attention import NEG_INF
from multimodal_timesfm_torch.ops.qkv_attention import split_heads
from tests.test_torch_port_short_backward import _segments
from tests.test_torch_tf32_model import CSRC, banks, const, wgmma3

HEADS, DIM, BATCH = 3, 64, 3
KERNEL_TOL = chip_smoke.KERNEL_TOL[torch.float32]
BWD_TOL = chip_smoke.BWD_TOL[torch.float32]
FWD_SRC = (CSRC / "chronos_attention_short_tf32.cu").read_text()
BWD_SRC = (CSRC / "chronos_attention_bwd_short_tf32.cu").read_text()
HEADER = (CSRC / "chronos_tf32_short.cuh").read_text()
SHORT_FWD_FROM = const("kShortFwdFrom", FWD_SRC)
SHORT_FWD_TO = const("kShortFwdTo", FWD_SRC)
BUILT_FWD_TO = const("kBuiltTo", FWD_SRC)
SHORT_TO = const("kShortTo", BWD_SRC)


# ------------------------------------------------------------------ the model


def _heads(qkv, g=None):
    q, k, v = (t.transpose(1, 2).float() for t in split_heads(qkv, HEADS, DIM))  # (B, H, S, D)
    if g is None:
        return q, k, v
    return q, k, v, g.unflatten(-1, (HEADS, DIM)).transpose(1, 2).float()


def _zeros(*shape):
    return torch.zeros(*shape, dtype=torch.float32)


def _weights(q, k, seg, bias, terms):
    """W of every row: the logits from the bias, Q K^T added per k-step, the mask, the whole
    row's max and sum, exp(l - m) times 1 / s."""
    same = (seg[:, :, None] == seg[:, None, :])[:, None]
    sc = wgmma3(bias[None].expand(q.shape[0], -1, -1, -1), q, k.transpose(-1, -2), terms)
    sc = torch.where(same, sc, NEG_INF)
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    return e * (1 / e.sum(-1, keepdim=True))


def persistent_forward(qkv, seg, bias, terms=3):
    """B4f on route 6 in its order: (B, S, H*D) fp32."""
    q, k, v = _heads(qkv)
    w = _weights(q, k, seg, bias, terms)
    o = wgmma3(_zeros(*q.shape), w, v, terms)
    return o.transpose(1, 2).flatten(-2)


def block_ranges(batch: int, blocks: int) -> list[range]:
    """Each block's batch rows, as the kernels split a head's rows: [p B / P, (p + 1) B / P)."""
    return [range(p * batch // blocks, (p + 1) * batch // blocks) for p in range(blocks)]


def persistent_backward(qkv, seg, bias, g, blocks=1, terms=3):
    """B4b on route 6 in its order: dqkv (B, S, 3*H*D) and dbias (H, S, S), fp32, the batch
    rows of a head over ``blocks`` blocks."""
    q, k, v, gg = _heads(qkv, g)
    batch, heads, seq, _ = q.shape
    same = (seg[:, :, None] == seg[:, None, :])[:, None]
    sc = wgmma3(bias[None].expand(batch, -1, -1, -1), q, k.transpose(-1, -2), terms)
    sc = torch.where(same, sc, NEG_INF)
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    dw = wgmma3(_zeros(batch, heads, seq, seq), gg, v.transpose(-1, -2), terms)
    inv = 1 / e.sum(-1, keepdim=True)
    w = e * inv
    r = (e * dw).sum(-1, keepdim=True) * inv
    dl = w * (dw - r)
    dq = wgmma3(_zeros(*q.shape), dl, k, terms)
    # Phase B over the SP query rows: the padded rows' W and dL meet zero rows of G and Q.
    pad = -seq % 16
    wp = torch.nn.functional.pad(w, (0, 0, 0, pad))
    dlp = torch.nn.functional.pad(dl, (0, 0, 0, pad))
    gp = torch.nn.functional.pad(gg, (0, 0, 0, pad))
    qp = torch.nn.functional.pad(q, (0, 0, 0, pad))
    dv = wgmma3(_zeros(*q.shape), wp.transpose(-1, -2), gp, terms)
    dk = wgmma3(_zeros(*q.shape), dlp.transpose(-1, -2), qp, terms)
    partials = []
    for rows in block_ranges(batch, blocks):
        acc = _zeros(heads, seq, seq)
        for b in rows:
            acc = acc + dl[b]
        partials.append(acc)
    dbias = _zeros(heads, seq, seq)
    for part in partials:
        dbias = dbias + part
    dqkv = torch.cat([d.transpose(1, 2).flatten(-2) for d in (dq, dk, dv)], dim=-1)
    return dqkv, dbias


# ------------------------------------------------------------------- inputs


def _case(seq, kind, seed=0):
    """fp32 qkv (entries of about dim^-1/4), a N(0, 1) bias, (B, S) ids ("one" segment,
    "padded": three with a fifth of the tokens padded, "sixteen": sixteen segments and the
    cotangent centred over each, times 8, so that dV keeps only W's spread) and a cotangent."""
    rng = np.random.default_rng(seed + 7 * seq)
    qkv = (rng.normal(size=(BATCH, seq, 3 * HEADS * DIM)) / DIM ** 0.25).astype(np.float32)
    bias = rng.normal(size=(HEADS, seq, seq)).astype(np.float32)
    seg = _segments(rng, kind, BATCH, seq)
    g = rng.normal(size=(BATCH, seq, HEADS * DIM)).astype(np.float32)
    if kind == "sixteen":
        same = (seg[:, :, None] == seg[:, None, :]).astype(np.float32)
        g = (8.0 * (g - np.einsum("bqk,bkc->bqc", same, g) / same.sum(-1, keepdims=True))).astype(np.float32)
    return qkv, seg, bias, g


@functools.cache
def _jax(seq, kind):
    """JAX's forward, dqkv and dbias at the case, as numpy arrays."""
    qkv, seg, bias, g = _case(seq, kind)
    out, vjp = jax.vjp(
        lambda t, b: j_chronos(t, jnp.asarray(seg), make_rowtile_bias(b, BATCH, seq), HEADS, DIM, True),
        jnp.asarray(qkv), jnp.asarray(bias),
    )
    dqkv, dbias = vjp(jnp.asarray(g))
    return tuple(np.asarray(x, np.float32) for x in (out, dqkv, dbias))


def _torch_case(seq, kind):
    return tuple(torch.from_numpy(x) for x in _case(seq, kind))


def _excess(out, ref, tol) -> float:
    """max(|out - ref| - atol - rtol |ref|): <= 0 within the tolerance, on every element."""
    out = out.float().numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    return float((np.abs(out - ref) - tol[0] - tol[1] * np.abs(ref)).max())


FORWARD_CASES = [(seq, kind) for seq in (5, 16, 17, 67, 80, 97, 128) for kind in ("one", "padded")]
FORWARD_CASES += [(80, "sixteen")]
BACKWARD_CASES = [(seq, kind) for seq in (5, 16, 17, 67, 80) for kind in ("one", "padded")]
BACKWARD_CASES += [(80, "sixteen")]


# -------------------------------------------------------------------- tests


@pytest.mark.parametrize("seq,kind", FORWARD_CASES)
def test_forward_matches_jax(seq, kind):
    """S = 5 to 128 (one tile of S rounded up to 16: 16-128 rows, 1-8 warps a group), one
    segment, three with padded tokens, sixteen."""
    qkv, seg, bias, _ = _torch_case(seq, kind)
    out = persistent_forward(qkv, seg, bias)
    assert out.shape == (BATCH, seq, HEADS * DIM)
    assert _excess(out, _jax(seq, kind)[0], KERNEL_TOL) <= 0


@pytest.mark.parametrize("seq,kind", BACKWARD_CASES)
def test_backward_matches_jax(seq, kind):
    """dqkv and dbias (the batch rows over two blocks a head) at S = 5 to 80; "sixteen" centres
    the cotangent over each segment's rows, so dV keeps only W's spread."""
    qkv, seg, bias, g = _torch_case(seq, kind)
    dqkv, dbias = persistent_backward(qkv, seg, bias, g, blocks=2)
    _, ref_dqkv, ref_dbias = _jax(seq, kind)
    assert _excess(dqkv, ref_dqkv, BWD_TOL) <= 0
    assert _excess(dbias, ref_dbias, BWD_TOL) <= 0


def test_model_matches_the_plain_version():
    """The card holds the kernels to the plain versions: the model stays within the same
    tolerances of them, at 67 tokens with padded tokens."""
    qkv, seg, bias, g = _torch_case(67, "padded")
    plain = tca.plain_chronos_attention(qkv, seg, bias)
    ref_dqkv, ref_dbias = tca.plain_chronos_attention_bwd(qkv, seg, bias, g, True)
    dqkv, dbias = persistent_backward(qkv, seg, bias, g, blocks=3)
    assert _excess(persistent_forward(qkv, seg, bias), plain.numpy(), KERNEL_TOL) <= 0
    assert _excess(dqkv, ref_dqkv.numpy(), BWD_TOL) <= 0
    assert _excess(dbias, ref_dbias.numpy(), BWD_TOL) <= 0


def test_one_tf32_product_misses_the_fp32_tolerance():
    """One TF32 product per pair (hi hi only) leaves the forward outside KERNEL_TOL and dqkv
    outside BWD_TOL at the fine-tune's 67 tokens: hence three on this route too."""
    qkv, seg, bias, g = _torch_case(67, "one")
    out, ref_dqkv, _ = _jax(67, "one")
    assert _excess(persistent_forward(qkv, seg, bias, terms=1), out, KERNEL_TOL) > 0
    assert _excess(persistent_backward(qkv, seg, bias, g, terms=1)[0], ref_dqkv, BWD_TOL) > 0


@pytest.mark.parametrize("batch,blocks", [(128, 11), (3, 3), (1, 1), (130, 11), (17, 22)])
def test_blocks_split_a_heads_rows_once_and_dbias_in_order(batch, blocks):
    """A head's P blocks take [p B / P, (p + 1) B / P): every batch row once, in order, none
    empty when P <= B (the rule caps P at B); the dbias partials, one a block, are summed in
    order by chronos_bwd_dbias_kernel, so two launches give the same bits."""
    blocks = min(blocks, batch)
    ranges = block_ranges(batch, blocks)
    assert [b for r in ranges for b in r] == list(range(batch)) and all(len(r) > 0 for r in ranges)
    for src in (BWD_SRC, FWD_SRC):
        assert "const int b0 = (int)((long long)part * B / P);" in src
        assert "const int nb = (int)((long long)(part + 1) * B / P) - b0;" in src
        assert "return p < 1 ? 1 : p > B ? B : p;" in src
    assert "float* plane = dbias + ((long long)part * H + h) * S * S;" in BWD_SRC
    assert not re.search(r"atomic", re.sub(r"//[^\n]*", "", BWD_SRC + FWD_SRC + HEADER))


def test_borders_follow_the_sources_and_route_6_comes_first():
    """The Python mirror of the borders (``CHRONOS_TF32_SHORT_FROM`` / ``_TO``,
    ``chronos_f32_route``) is the sources' ``kShortFwdFrom`` / ``kShortFwdTo`` / ``kShortTo``,
    which the ``[gate] chronos fp32 persistent`` lines set (the forward from 17 to 112 tokens,
    the backward up to 80, the lengths Chronos-2's fine-tune and serving at context 512 run);
    make_plan asks route 6 before route 5 (and route 7, which takes the lengths past route 6's
    borders); the overrides "cuda cores" (4), "tf32 mma.sync" (5) and "tf32 wgmma" (7) keep fp32 off
    route 6, "tf32 persistent" (6) forces it at every S it is built for."""
    assert _kernels.CHRONOS_TF32_SHORT_FROM == {"forward": SHORT_FWD_FROM, "backward": 1}
    assert _kernels.CHRONOS_TF32_SHORT_TO == {"forward": SHORT_FWD_TO, "backward": SHORT_TO}
    assert (SHORT_FWD_FROM, SHORT_FWD_TO, BUILT_FWD_TO, SHORT_TO) == (17, 112, 128, 80)
    for backward, lo, hi in ((False, SHORT_FWD_FROM, SHORT_FWD_TO), (True, 1, SHORT_TO)):
        assert _kernels.chronos_f32_route(backward, lo, 64) == _kernels.chronos_f32_route(backward, hi, 64) == 6
        assert _kernels.chronos_f32_route(backward, hi + 1, 64) == 5  # route 7 from its own borders on
        assert _kernels.chronos_f32_route(backward, 16, 128) == 0
    assert _kernels.chronos_f32_route(False, SHORT_FWD_FROM - 1, 64) == 5
    assert {_kernels.chronos_f32_route(b, s, 64) for b, s in ((False, 67), (False, 97), (True, 67), (True, 80))} == {6}
    assert "if (D != kD || S < 1 || S > kBuiltTo || force == 4 || force == 5 || force == 7) return 0;" in FWD_SRC
    assert "return force == 6 || (S >= kShortFwdFrom && S <= kShortFwdTo);" in FWD_SRC
    assert "return D == kD && S >= 1 && S <= kShortTo && force != 4 && force != 5 && force != 7;" in BWD_SRC
    common = (CSRC / "chronos_common.cuh").read_text()
    plan = common[common.index("inline Plan make_plan("):]
    assert plan.index("chronos_short_tf32_takes(S, D)") < plan.index("chronos_tf32_takes(D)")
    assert plan.index("chronos_short_tf32_fwd_takes(S, D)") < plan.index("chronos_tf32_takes(D)")
    names = _kernels.CHRONOS_ROUTE_NAMES
    assert names["tf32 persistent"] == 6 == _kernels._CHRONOS_ROUTES.index(
        "fp32 3xTF32 mma.sync m16n8k8 fed by TMA, persistent, one pass")
    assert names["tf32 mma.sync"] == 5 and names["wgmma"] == 3 and names["cuda cores"] == 4
    assert chip_smoke.B4_ROUTES[6] == "tf32 persistent"


def _smem(src: str, nq: int, operands: int, staging: bool, most: int) -> tuple[int, int]:
    """(stages, bytes) of a block at SP = 16 nq, as the sources' Cfg computes them: the backward's
    buffer holds k's and v's lo twins, then W's staging over v's twin and dL's over k's."""
    limit = 232448
    sp = 16 * nq
    tile = sp * 4 * DIM
    stage = operands * tile
    plane = sp * (sp + 4) * 4
    buffer = max(2 * plane, 2 * tile) + 3 * 2 * sp * 4 if staging else 0  # and the halves' exchange
    fixed = 1024 + buffer + most * sp * 4 + 16 * most + (8 if staging else 0)
    stages = min(most, (limit - fixed) // stage)
    return stages, fixed + stages * stage


def test_shared_memory_holds_the_ring_and_the_staging():
    """The backward's block holds at least two stages of q, k, v and g beside its buffer (k's and
    v's lo twins, then W's and dL's staging) at every SP up to 80 (two at SP = 64-80, four up to
    48), the forward's two stages of q, k and v (and up to 80 tokens their twins) up to SP = 128;
    staging rows SP + 4 floats apart meet 32 banks in load_at's pattern."""
    assert "static constexpr int LDW = SP + 4;" in BWD_SRC
    assert "constexpr int kMaxStagesB = 4;" in BWD_SRC and "constexpr int kStagesMax = 6;" in FWD_SRC
    for nq in range(1, SHORT_TO // 16 + 1):
        stages, size = _smem(BWD_SRC, nq, 4, True, 4)
        assert stages >= 2 and size <= 232448
        assert sorted(banks(16 * nq + 4)["8t+g"]) == list(range(32))
    assert [_smem(BWD_SRC, nq, 4, True, 4)[0] for nq in range(1, 6)] == [4, 4, 4, 2, 2]
    assert "static constexpr int STAGING = 2 * PLANE > 2 * TILE ? 2 * PLANE : 2 * TILE;" in BWD_SRC
    for nq in range(1, BUILT_FWD_TO // 16 + 1):
        if nq in (6, 7):  # one group: two stages and the block's twins
            sp = 16 * nq
            stages, size = 2, 1024 + 2 * sp * 4 + 32 + 2 * sp * 4 * DIM + 2 * 3 * sp * 4 * DIM
        else:  # two groups: k's and v's twins in each stage; S = 113-128: no twins
            stages, size = _smem(FWD_SRC, nq, 5 if nq <= 5 else 3, False, 6)
        assert stages >= 2 and size <= 232448
    assert _smem(FWD_SRC, 8, 3, False, 6)[0] == 2 and _smem(FWD_SRC, 5, 5, False, 6)[0] == 2
    assert "static constexpr bool BLOCK_TWINS = G == 1 && TWO + 2 * TILE + 2 * STAGE <= kSmemLimit;" in FWD_SRC


def _chunk_address(sp: int, r: int, c: int) -> int:
    """The byte address of row r, columns c..c+3 of an SP-row fp32 tile as TMA lays it: two
    32-column boxes, each SP x 128 bytes under the 128-byte swizzle."""
    return (c >> 5) * sp * 128 + r * 128 + ((((c >> 2) ^ r) & 7) << 4)


def test_swizzled_fragment_loads_meet_distinct_banks():
    """On the TMA tiles (two 32-column boxes under the 128-byte swizzle) each ldmatrix matrix's
    eight 16-byte rows lie in eight distinct groups of four banks, and the scalar loads of P Y's
    B operand (rows k0 + 2t, k0 + 2t + 1, column n0 + g) meet 32 distinct banks."""
    assert "(16-byte chunk c of row r at\n// chunk c ^ (r % 8))" in HEADER and "columns 0-31, then 32-63" in HEADER
    for sp in (16, 80, 128):
        for r0 in range(0, sp, 8):
            for c0 in range(0, DIM, 4):
                groups = {(_chunk_address(sp, r0 + i, c0) // 16) % 8 for i in range(8)}
                assert len(groups) == 8
        for k0 in range(0, sp, 8):
            for n0 in range(0, DIM, 8):
                for dr in (0, 1):
                    words = [(_chunk_address(sp, k0 + 2 * (lane & 3) + dr, (n0 + (lane >> 2)) & ~3)
                              + 4 * ((n0 + (lane >> 2)) & 3)) // 4 % 32 for lane in range(32)]
                    assert sorted(words) == list(range(32))


def test_lane_tables_give_the_swizzled_addresses():
    """The loaders' per-lane address parts (``Lanes``) plus each k-step's or n-tile's constant
    are Tile32's swizzled addresses of the fragments tf32_common's loaders read: load_a's and
    load_bt2's ldmatrix rows, load_bp's scalar loads, at every lane, k-step and n-tile of tiles
    of 16, 80 and 128 rows."""
    assert "a[q] = ((i & 1) * 8 + l7) * 128 + ((((2 * q + (i >> 1)) ^ l7) & 7) << 4);" in HEADER
    assert "b[q] = ((i >> 1) * 8 + l7) * 128 + ((((2 * q + (i & 1)) ^ l7) & 7) << 4);" in HEADER
    assert ("p[dr][q] = (2 * t + dr) * 128 + ((((2 * q + (g >> 2)) ^ (2 * t + dr)) & 7) << 4) + (g & 3) * 4;"
            in HEADER)

    def at(sp, r, c):
        return _chunk_address(sp, r, c & ~3) + (c & 3) * 4

    for lane in range(32):
        i, l7, t, g = lane >> 3, lane & 7, lane & 3, lane >> 2
        a = [((i & 1) * 8 + l7) * 128 + ((((2 * q + (i >> 1)) ^ l7) & 7) << 4) for q in range(4)]
        b = [((i >> 1) * 8 + l7) * 128 + ((((2 * q + (i & 1)) ^ l7) & 7) << 4) for q in range(4)]
        p = [[(2 * t + dr) * 128 + ((((2 * q + (g >> 2)) ^ (2 * t + dr)) & 7) << 4) + (g & 3) * 4
              for q in range(4)] for dr in range(2)]
        for sp in (16, 80, 128):
            for s in range(DIM // 8):
                for r0 in range(0, sp, 16):
                    assert (s >> 2) * sp * 128 + r0 * 128 + a[s & 3] == _chunk_address(
                        sp, r0 + (i & 1) * 8 + l7, 8 * s + (i >> 1) * 4)
                for n in range(0, sp // 8 - 1):
                    assert (s >> 2) * sp * 128 + n * 8 * 128 + b[s & 3] == _chunk_address(
                        sp, 8 * n + (i >> 1) * 8 + l7, 8 * s + (i & 1) * 4)
            for k0 in range(0, sp, 8):
                for n in range(DIM // 8):
                    for dr in (0, 1):
                        assert (n >> 2) * sp * 128 + k0 * 128 + p[dr][n & 3] == at(sp, k0 + 2 * t + dr, 8 * n + g)


def test_no_w_or_dl_scratch_in_device_memory():
    """The backward keeps W and dL in shared memory: its entry takes no scratch, and the buffers
    the library asks the wrapper for are none on routes 4 and 6."""
    entry = BWD_SRC[BWD_SRC.index('extern "C" int chronos_short_tf32_bwd('):]
    assert "scratch" not in entry.split("{")[0]
    dispatch = (CSRC / "chronos_attention_bwd.cu").read_text()
    assert "*stats = p.route == 4 || p.route == 6 ? 0" in dispatch
    assert "chronos_short_tf32_bwd(qkv, seg, bias, g, dqkv, part, p.groups, B, S, H, st)" in dispatch


def test_products_are_tf32_mma_sync_fed_by_tma():
    """Both kernels take their tiles by TMA (cp.async.bulk.tensor through hopper_common's
    tma_load) as fp32 boxes of 32 columns under the 128-byte swizzle, and every product through
    tf32_common's mma3 (lo hi + hi lo + hi hi); no library call, no per-thread copy."""
    assert "CU_TENSOR_MAP_DATA_TYPE_FLOAT32" in HEADER and "CU_TENSOR_MAP_SWIZZLE_128B" in HEADER
    assert "tma_load(smem + st * STAGE + op * TILE + box * SP * 128" in HEADER
    assert HEADER.count("mma3(") >= 3 and '#include "tf32_common.cuh"' in HEADER
    # The split: hi the value as it lies, lo = tf32(x - trunc(x)), as route 5's.
    assert "return __float_as_uint(__uint_as_float(x) - __uint_as_float(x & 0xffffe000u)) + 0x1000u;" in HEADER
    assert "write_lo(sb + C::TILE, kv, 2 * C::TILE," in FWD_SRC
    assert "write_lo(sb + C::TILE, twins, 2 * C::TILE, threadIdx.x, C::NC);" in BWD_SRC
    for src in (FWD_SRC, BWD_SRC, HEADER):
        code = re.sub(r"//[^\n]*", "", src)
        assert not re.search(r"cp_async|cublas|cudnn|scaled_dot_product|#include <torch|jax", code, re.I)
    for name in ("chronos_attention_short_tf32.cu", "chronos_attention_bwd_short_tf32.cu"):
        assert CSRC / name in _kernels.SOURCES


def test_chip_smoke_gates_checks_and_counts_route_6():
    """chip_smoke.py checks route 6 at every S up to its borders in the Chronos kernel phase,
    times it against route 5 in ``[gate] chronos fp32 persistent`` lines under --kernel-times
    only, requires HMMA.1688.F32.TF32 and UTMALDG in its kernels, counts its main-path launches
    ("B4f tf32 persistent", "B4b tf32 persistent") and fails when one is 0, and gives it rows of
    its own in the kernels line."""
    assert "tf32_persistent_checks(gen)" in inspect.getsource(chip_smoke.chronos_kernel_phase)
    main = inspect.getsource(chip_smoke.main)
    before, after = main.split("def phase(")
    assert "chronos_f32_persistent_borders(args.seed)" in before and "chronos_f32_persistent_borders" not in after
    assert 'phase("batch chunks", batch_chunk_checks, args.seed)' in after
    assert set(chip_smoke.TF32_PERSISTENT_FAMILIES) == {"chronos_fwd_short_tf32_kernel",
                                                         "chronos_bwd_short_tf32_kernel"}
    for family in chip_smoke.TF32_PERSISTENT_FAMILIES:
        assert f"    {family}(" in FWD_SRC + BWD_SRC
    report = inspect.getsource(chip_smoke.sass_mma_report)
    assert "for name in TF32_PERSISTENT_FAMILIES" in report and 'c[SASS_TF32] == 0 or c["UTMALDG"] == 0' in report
    assert 'idle += [f"{key} tf32 persistent" for key, *_ in TF32_PERSISTENT_KERNELS' in main
    assert {67, 80, 97, 128} <= set(chip_smoke.F32_PERSISTENT_BORDER_LENGTHS)
    shape = (128, 67, 12, 64)
    rows = {chip_smoke.row_key(key, shape, torch.float32): {"ms": 1.0 + i} for i, key in enumerate(("B4f", "B4b"))}
    entries = chip_smoke.tf32_persistent_entries(rows, {"B4f tf32 persistent": 7, "B4b tf32 persistent": 4,
                                                        "B4f tf32": 1})
    assert [(e["name"], e["launches"], e["ms"]) for e in entries] == [
        ("fused_chronos_attention (3xTF32 persistent route)", 7, 1.0),
        ("fused_chronos_attention_bwd (3xTF32 persistent route)", 4, 2.0)]
    assert [e["source"].rsplit("/", 1)[1] for e in entries] == ["chronos_attention_short_tf32.cu",
                                                               "chronos_attention_bwd_short_tf32.cu"]
    assert (128, 67, 6) in chip_smoke.CHRONOS_PATH_SHAPES and (64, 97, 12) in chip_smoke.CHRONOS_PATH_SHAPES
