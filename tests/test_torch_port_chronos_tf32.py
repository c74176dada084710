"""The 3xTF32 route of B4f and B4b (fp32, head_dim 64), against the JAX package.

The route (``csrc/chronos_attention_tf32.cu``, ``csrc/chronos_attention_bwd_tf32.cu``, plan
route 5) runs only on the card; ``chip_smoke.py`` holds it against the plain version there.
What can be checked here is its arithmetic: the model below repeats, in PyTorch on the CPU,
what the kernels compute and in which order, and is held against JAX's
``fused_chronos_attention`` in fp32 (the Pallas kernel in interpret mode, as the JAX package's
own tests run it) and its VJP within the tolerances ``chip_smoke.py`` holds the kernels to
(``KERNEL_TOL`` and ``BWD_TOL`` in fp32) on every element.

- TF32: an fp32 value rounded to 10 mantissa bits, to nearest, ties away from zero (what
  ``cvt.rna.tf32.f32`` does; the kernels do it in two integer instructions); x splits into hi =
  tf32(x) and lo = tf32(x - hi).
- A product is taken per k-step of 8 as three ``mma.sync`` m16n8k8: lo hi, hi lo, hi hi, in that
  order, each summing its 8 exact products into the fp32 accumulator (one rounding).
- Forward: one pass over key tiles (S padded to 16 up to 80 tokens, else 64 keys) with an online
  softmax: running max m, the sum l and the output rescaled by exp(m_old - m) when m grows,
  divided by l at the end.
- Backward: kernel 1 walks the key tiles for m, s = sum exp(l - m) and t = sum exp(l - m) dW
  (online), r = t / s, then W = exp(l - m) (1 / s), dL = W (dW - r) and dQ = dL K, and writes W
  and dL to a scratch; kernel 2 takes dV = W^T G and dK = dL^T Q from them; kernel 3 sums dL over
  the batch rows in batch order.
"""

import functools
import inspect
import math
import re
from pathlib import Path

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
from tests.test_torch_tf32_model import COMMON
from tests.test_torch_tf32_model import const as _const
from tests.test_torch_tf32_model import mma3, split, tf32  # noqa: F401 (the model's pieces, shared)

HEADS, DIM, BATCH = 2, 64, 2
CSRC = Path(tca.__file__).resolve().parent.parent / "csrc"
KERNEL_TOL = chip_smoke.KERNEL_TOL[torch.float32]
BWD_TOL = chip_smoke.BWD_TOL[torch.float32]


_HEADER = (CSRC / "chronos_tf32.cuh").read_text()
ONE_TILE_TO = _const("kOneTileTo", _HEADER)
TILE = _const("kTile", _HEADER)


def tile_rows(seq: int) -> int:
    """Query and key rows a tile of the route at S (``tile_rows`` in chronos_tf32.cuh)."""
    return -(-seq // 16) * 16 if seq <= ONE_TILE_TO else TILE


_BWD = (CSRC / "chronos_attention_bwd_tf32.cu").read_text()
SCRATCH_FLOATS = 1 << int(re.search(r"constexpr long long kScratchFloats = 1LL << (\d+);", _BWD).group(1))


def row_floats(seq: int, heads: int) -> int:
    """W and dL of one batch row in the backward's scratch (``row_floats``)."""
    kt = tile_rows(seq)
    return 2 * heads * (-(-seq // kt)) ** 2 * kt * kt


def chunk_rows(batch: int, seq: int, heads: int) -> int:
    """Batch rows a chunk of the backward (``chunk_rows``): as many as fit SCRATCH_FLOATS, at
    least one, the chunks as even as their count allows."""
    most = min(batch, max(1, SCRATCH_FLOATS // row_floats(seq, heads)))
    chunks = -(-batch // most)
    return -(-batch // chunks)


# ------------------------------------------------------------------ the model


# The rounding, the split and the three products per k-step (tests/test_torch_tf32_model.py, shared with
# the causal route's tests): tf32, split, mma3.


def _heads(qkv, g=None):
    q, k, v = (t.transpose(1, 2).float() for t in split_heads(qkv, HEADS, DIM))  # (B, H, S, D)
    if g is None:
        return q, k, v
    return q, k, v, g.unflatten(-1, (HEADS, DIM)).transpose(1, 2).float()


def _zeros(*shape):
    return torch.zeros(*shape, dtype=torch.float32)


def tf32_forward(qkv, seg, bias, terms=3):
    """B4f on the route in its order: (B, S, H*D) fp32."""
    q, k, v = _heads(qkv)
    batch, heads, seq, _ = q.shape
    same = (seg[:, :, None] == seg[:, None, :])[:, None]
    m = torch.full((batch, heads, seq), NEG_INF)
    l = _zeros(batch, heads, seq)
    o = _zeros(batch, heads, seq, DIM)
    kt = tile_rows(seq)
    for k0 in range(0, seq, kt):
        keys = slice(k0, min(seq, k0 + kt))
        sc = mma3(_zeros(batch, heads, seq, keys.stop - k0), q, k[:, :, keys].transpose(-1, -2), terms)
        sc = torch.where(same[..., keys], sc + bias[None, :, :, keys], NEG_INF)
        nm = torch.maximum(m, sc.amax(-1))
        scale = torch.exp(m - nm)
        p = torch.exp(sc - nm[..., None])
        l = l * scale + p.sum(-1)
        o = mma3(o * scale[..., None], p, v[:, :, keys], terms)
        m = nm
    return (o * (1 / l)[..., None]).transpose(1, 2).flatten(-2)


def tf32_backward(qkv, seg, bias, g, terms=3):
    """B4b on the route in its order: dqkv (B, S, 3*H*D) and dbias (H, S, S), fp32."""
    q, k, v, gg = _heads(qkv, g)
    batch, heads, seq, _ = q.shape
    same = (seg[:, :, None] == seg[:, None, :])[:, None]
    zero = _zeros(batch, heads, seq, seq)
    # Kernel 1: S, dW; online m, s, t over the key tiles; r = t / s; W, dL; dQ.
    logits = torch.where(same, mma3(zero, q, k.transpose(-1, -2), terms) + bias[None], NEG_INF)
    dw = mma3(zero, gg, v.transpose(-1, -2), terms)
    m = torch.full((batch, heads, seq), NEG_INF)
    s = _zeros(batch, heads, seq)
    t = _zeros(batch, heads, seq)
    kt = tile_rows(seq)
    for k0 in range(0, seq, kt):
        keys = slice(k0, min(seq, k0 + kt))
        nm = torch.maximum(m, logits[..., keys].amax(-1))
        scale = torch.exp(m - nm)
        e = torch.exp(logits[..., keys] - nm[..., None])
        s = s * scale + e.sum(-1)
        t = t * scale + (e * dw[..., keys]).sum(-1)
        m = nm
    r = t / s
    w = torch.exp(logits - m[..., None]) * (1 / s)[..., None]
    dl = w * (dw - r[..., None])
    dq = mma3(_zeros(batch, heads, seq, DIM), dl, k, terms)
    # Kernel 2: dV = W^T G and dK = dL^T Q from kernel 1's W and dL.
    dv = mma3(_zeros(batch, heads, seq, DIM), w.transpose(-1, -2), gg, terms)
    dk = mma3(_zeros(batch, heads, seq, DIM), dl.transpose(-1, -2), q, terms)
    # Kernel 3: dL summed over the batch rows in order.
    dbias = _zeros(heads, seq, seq)
    for b in range(batch):
        dbias = dbias + dl[b]
    dqkv = torch.cat([d.transpose(1, 2).flatten(-2) for d in (dq, dk, dv)], dim=-1)
    return dqkv, dbias


# ------------------------------------------------------------------- inputs


def _case(seq, kind, seed=0):
    """fp32 qkv (entries of about dim^-1/4; "large": q times 4, logits of tens), a N(0, 1) bias
    ("lastrow": its last row plus 100, past where exp overflows), (B, S) ids ("one" segment, as
    "lastrow", "padded": three with a fifth of the tokens padded, "sixteen": sixteen segments and
    the cotangent centred over each, times 8, so that dV keeps only W's spread) and a cotangent."""
    rng = np.random.default_rng(seed + seq)
    qkv = (rng.normal(size=(BATCH, seq, 3 * HEADS * DIM)) / DIM ** 0.25).astype(np.float32)
    if kind == "large":
        qkv[..., : HEADS * DIM] *= 4
    bias = rng.normal(size=(HEADS, seq, seq)).astype(np.float32)
    if kind == "lastrow":
        bias[:, -1] += 100
    seg = _segments(rng, {"large": "padded", "lastrow": "one"}.get(kind, kind), BATCH, seq)
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


CASES = [(seq, kind) for seq in (67, 97, 577) for kind in ("one", "padded")]
CASES += [(67, "large"), (577, "large"), (97, "sixteen"), (577, "sixteen")]


# -------------------------------------------------------------------- tests


def test_tf32_rounds_to_ten_mantissa_bits_ties_away_from_zero():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, -7.25,
                      65504.0 + 2 ** -3])
    hi = tf32(x)
    assert torch.equal(hi, torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0, -7.25, 65504.0]))
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()


def test_split_keeps_the_value_to_two_to_the_minus_22():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=100000).astype(np.float32)) * 37
    hi, lo = split(x)
    assert ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).eq(0).all()
    assert ((x - hi).abs() <= 2 ** -11 * x.abs()).all()
    assert ((x.double() - hi.double() - lo.double()).abs() <= 2 ** -22 * x.double().abs()).all()


@pytest.mark.parametrize("seq,kind", CASES)
def test_forward_matches_jax(seq, kind):
    """67 tokens: one tile of 80 rows (13 padded); 97 and 577: 64-row tiles, the online softmax
    across 2 and 10 of them. One segment, three with padded tokens, q times 4 (logits of tens)
    and sixteen segments."""
    qkv, seg, bias, _ = _torch_case(seq, kind)
    out = tf32_forward(qkv, seg, bias)
    assert out.shape == (BATCH, seq, HEADS * DIM)
    assert _excess(out, _jax(seq, kind)[0], KERNEL_TOL) <= 0


@pytest.mark.parametrize("seq,kind", CASES)
def test_backward_matches_jax(seq, kind):
    """dqkv and dbias at the same cases; "sixteen" centres the cotangent over each segment's rows,
    so dV keeps only W's spread (the fp32 dV-cancelling case)."""
    qkv, seg, bias, g = _torch_case(seq, kind)
    dqkv, dbias = tf32_backward(qkv, seg, bias, g)
    _, ref_dqkv, ref_dbias = _jax(seq, kind)
    assert _excess(dqkv, ref_dqkv, BWD_TOL) <= 0
    assert _excess(dbias, ref_dbias, BWD_TOL) <= 0


def test_model_matches_the_plain_version():
    """The card holds the kernels to the plain versions: the model stays within the same
    tolerances of them, at 97 tokens with padded tokens."""
    qkv, seg, bias, g = _torch_case(97, "padded")
    out = tf32_forward(qkv, seg, bias)
    dqkv, dbias = tf32_backward(qkv, seg, bias, g)
    plain = tca.plain_chronos_attention(qkv, seg, bias)
    ref_dqkv, ref_dbias = tca.plain_chronos_attention_bwd(qkv, seg, bias, g, True)
    assert _excess(out, plain.numpy(), KERNEL_TOL) <= 0
    assert _excess(dqkv, ref_dqkv.numpy(), BWD_TOL) <= 0
    assert _excess(dbias, ref_dbias.numpy(), BWD_TOL) <= 0


@pytest.mark.parametrize("seq,kind", [(67, "one"), (577, "large")])
def test_one_tf32_product_misses_the_fp32_tolerance(seq, kind):
    """One TF32 product per pair (hi hi only: operands rounded to 2^-11) moves the logits by about
    2^-11 of |q||k| and leaves the forward outside KERNEL_TOL, and dqkv outside BWD_TOL: hence
    three."""
    qkv, seg, bias, g = _torch_case(seq, kind)
    out, ref_dqkv, _ = _jax(seq, kind)
    assert _excess(tf32_forward(qkv, seg, bias, terms=1), out, KERNEL_TOL) > 0
    assert _excess(tf32_backward(qkv, seg, bias, g, terms=1)[0], ref_dqkv, BWD_TOL) > 0


def test_one_pass_forward_equals_the_whole_row_softmax_at_one_tile():
    """Up to 80 tokens the online softmax sees one tile: its m and l are the whole row's, as JAX
    computes them; past that the rescaled sums stay within fp32 rounding of the two-pass
    result."""
    qkv, seg, bias, _ = _torch_case(97, "padded")
    q, k, v = _heads(qkv)
    same = (seg[:, :, None] == seg[:, None, :])[:, None]
    sc = torch.where(same, mma3(_zeros(BATCH, HEADS, 97, 97), q, k.transpose(-1, -2)) + bias[None], NEG_INF)
    w = torch.softmax(sc, dim=-1)
    two_pass = mma3(_zeros(BATCH, HEADS, 97, DIM), w, v).transpose(1, 2).flatten(-2)
    assert _excess(tf32_forward(qkv, seg, bias), two_pass.numpy(), (1e-6, 1e-5)) <= 0


@pytest.mark.parametrize("batch,seq,heads", [(128, 67, 12), (16, 577, 12), (64, 97, 12), (3, 5, 2),
                                              (512, 67, 12), (160, 577, 12), (1, 2048, 12)])
def test_scratch_holds_w_and_dl_of_every_tile_pair(batch, seq, heads):
    """The backward's scratch (``chronos_tf32_scratch``): W and dL of one chunk of batch rows,
    each (chunk rows) H tile pairs of KT^2 floats, within 1 GiB unless one row is more; the
    chunks as even as their count allows (16 x 577 x 12 whole, 629 MB; 160 x 577 x 12 in six
    chunks of 27 rows, 1062 MB each). No shape leaves the route for its scratch."""
    assert "return chunk_rows(B, S, H) * row_floats(S, H);" in _BWD
    assert "return 2LL * H * nt * nt * KT * KT;" in _BWD
    assert SCRATCH_FLOATS * 4 == 1 << 30
    rows = chunk_rows(batch, seq, heads)
    chunks = -(-batch // rows)
    floats = rows * row_floats(seq, heads)
    assert 1 <= rows <= batch and chunks * rows - batch < chunks
    assert floats <= max(SCRATCH_FLOATS, row_floats(seq, heads))
    if (batch, seq, heads) == (16, 577, 12):
        assert (rows, chunks, round(floats * 4 / 1e6)) == (16, 1, 629)
    if (batch, seq, heads) in ((128, 67, 12), (512, 67, 12)):
        assert chunks == 1  # the fine-tune's and the sweep group's shapes stay whole
    if (batch, seq, heads) == (160, 577, 12):
        assert (rows, chunks, round(floats * 4 / 1e6)) == (27, 6, 1062)
    common = (CSRC / "chronos_common.cuh").read_text()
    assert "kMaxTf32Scratch" not in common and "chronos_tf32_scratch" not in common


def test_dbias_chunks_sum_the_batch_rows_in_order():
    """Kernel 3 runs once a chunk and starts each element from the chunks' sum before it
    (``carry``): the same additions in the same order as one sum over the whole batch, so the
    chunked dbias is bit-equal to the unchunked one, and two launches to each other."""
    assert "float acc = carry ? dbias[e] : 0.f;" in _BWD
    assert "dbias, nb, S, H, KT, b0 > 0);" in _BWD
    dl = torch.from_numpy(np.random.default_rng(3).normal(size=(16, 2, 9, 9)).astype(np.float32)) * 1e3
    whole = _zeros(2, 9, 9)
    for b in range(16):
        whole = whole + dl[b]
    rows = 6  # three chunks: 6, 6, 4
    chunked = _zeros(2, 9, 9)
    for b0 in range(0, 16, rows):
        acc = chunked if b0 > 0 else _zeros(2, 9, 9)
        for b in range(b0, min(16, b0 + rows)):
            acc = acc + dl[b]
        chunked = acc
    assert torch.equal(chunked, whole)


def test_plan_borders_and_tiles_read_from_the_sources():
    """Route 5 takes fp32 at head_dim 64 at every S that route 6 leaves (the [gate] lines found it
    the faster than the CUDA cores at every measured length, so there is no border), unless the
    route override 4 ("cuda cores") keeps fp32 on the CUDA cores; the plan's tile rule is the kernels' (one tile of S padded to 16 up
    to kOneTileTo = 80, else 64 rows); the CUDA-core route keeps the other head dims."""
    fwd = (CSRC / "chronos_attention_tf32.cu").read_text()
    common = (CSRC / "chronos_common.cuh").read_text()
    assert (ONE_TILE_TO, TILE) == (80, 64)
    assert "kFwdFrom" not in fwd and "kBwdFrom" not in fwd
    assert 'int chronos_tf32_takes(int D) { return D == kD && mtt_chronos_route_override() != 4; }' in fwd
    assert f"const int tile = S <= {ONE_TILE_TO} ? (S + 15) / 16 * 16 : {TILE};" in common
    assert "if (dtype == 0 && chronos_tf32_takes(D)) {" in common
    assert "p = {5, 2 * tile, tile, tile, passes, 1, 1, 64, 64, 0};" in common
    assert [tile_rows(s) for s in (5, 16, 17, 67, 80, 81, 577)] == [16, 16, 32, 80, 80, 64, 64]


def test_bit_rounding_is_round_to_nearest_ties_away():
    """The kernels' rounding (``round_tf32``: half a TF32 ulp added to the bits, 13 low bits
    cleared) is cvt.rna.tf32.f32's: against |x| / q rounded half away from zero, q the TF32 ulp of
    x, on random values of every sign and scale and on exact ties."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=50000) * np.exp2(rng.integers(-60, 60, size=50000))).astype(np.float32)
    ties = ((1 + rng.integers(0, 1024, size=5000) * 2.0 ** -10 + 2.0 ** -11)
            * np.exp2(rng.integers(-20, 20, size=5000)) * rng.choice([-1, 1], size=5000)).astype(np.float32)
    x = np.concatenate([x, ties])
    q = np.exp2(np.floor(np.log2(np.abs(x.astype(np.float64)))) - 10)
    want = np.sign(x) * np.floor(np.abs(x.astype(np.float64)) / q + 0.5) * q
    assert np.array_equal(tf32(torch.from_numpy(x)).numpy().astype(np.float64), want)
    assert "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in COMMON


def test_products_are_mma_sync_tf32_with_the_split_in_the_kernel():
    """The route's products are mma.sync m16n8k8 TF32 instructions in the kernels' own bodies, the
    hi/lo split there (lo as the rounding's carry, which the tensor cores truncate to the same
    TF32 value), three products a pair, small terms first; no library call."""
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in COMMON
    split = re.search(r"void split\(.*?\n}\n", COMMON, re.S).group(0)
    assert "hi = round_tf32(x);" in split and "lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;" in split
    body = re.search(r"void mma3\(.*?\n}\n", COMMON, re.S).group(0)
    assert body.index("a.lo, b.hi") < body.index("a.hi, b.lo") < body.index("a.hi, b.hi")
    for name in ("chronos_attention_tf32.cu", "chronos_attention_bwd_tf32.cu"):
        src = (CSRC / name).read_text()
        assert CSRC / name in _kernels.SOURCES
        assert '#include "chronos_tf32.cuh"' in src and '#include "tf32_common.cuh"' in _HEADER
        assert not re.search(r"cublas|cudnn|#include <torch|#include <ATen", src, re.I)


def test_chip_smoke_names_the_tf32_route_its_gate_lines_and_launches():
    """chip_smoke.py names route 5 in its [route] and [launches] lines, times it against the
    CUDA-core route at S = 16-577 ([gate] lines, under --kernel-times only), checks fp32 where
    dV's terms cancel, gives the route's rows the 3xTF32 bound as their bound (the CUDA cores'
    beside it) and requires HMMA.1688.F32.TF32 in the route's kernels that take products."""
    timed = inspect.getsource(chip_smoke.chronos_timed_rows)
    assert 'tf32 = _kernels.chronos_plan(backward, dtype, batch, seq, heads, dim)["route"] in (5, 6, 7)' in timed
    assert "three_tf32=tf32" in timed and 'row["bound_cuda_cores_ms"], _ = chronos_bound(' in timed
    assert chip_smoke.B4_ROUTES[5] == "tf32" and "tf32" in _kernels._CHRONOS_ROUTES[5].lower()
    assert _kernels.CHRONOS_ROUTE_NAMES == {"rule": 0, "mma.sync": 1, "wgmma": 3, "cuda cores": 4,
                                            "tf32 mma.sync": 5, "tf32 persistent": 6, "tf32 wgmma": 7}
    assert "if (route < 0 || route > 7 || route == 2) return (int)cudaErrorInvalidValue;" in (
        CSRC / "chronos_attention_hopper.cu").read_text()
    assert "chronos_f32_borders" not in inspect.getsource(chip_smoke.main).split("def phase(")[1]
    assert chip_smoke.F32_BORDER_LENGTHS[0] == 16 and chip_smoke.F32_BORDER_LENGTHS[-1] == 577
    assert 67 in chip_smoke.F32_BORDER_LENGTHS and 97 in chip_smoke.F32_BORDER_LENGTHS
    assert set(chip_smoke.TF32_FAMILIES) == {"chronos_fwd_tf32_kernel", "chronos_bwd_dq_tf32_kernel",
                                             "chronos_bwd_dkdv_tf32_kernel"}
    for family in chip_smoke.TF32_FAMILIES:
        assert f"    {family}(" in "".join(
            (CSRC / n).read_text() for n in ("chronos_attention_tf32.cu", "chronos_attention_bwd_tf32.cu"))
    assert torch.float32 in chip_smoke.DV_CANCEL_DTYPES
    # Routes 6 and 7 take every fp32 Chronos launch of Chronos-2's main paths (67, 80 and 97 tokens;
    # 193 and 577), so route 5 has no main-path launch and no entry in the kernels line; route 7's
    # rows stand there instead.
    assert not hasattr(chip_smoke, "TF32_KERNELS") and not hasattr(chip_smoke, "tf32_route_entries")
    shape = (16, 577, 12, 64)
    rows = {chip_smoke.row_key(key, shape, torch.float32): {"ms": 1.0 + i} for i, key in enumerate(("B4f", "B4b"))}
    entries = chip_smoke.tf32w_chronos_entries(rows, {"B4f tf32": 5, "B4b tf32 wgmma": 3, "B4f tf32 wgmma": 2})
    assert [(e["launches"], e["ms"]) for e in entries] == [(2, 1.0), (3, 2.0)]
    assert all("chronos_attention_tf32.cu" not in e["source"] for e in entries)
    bound, by = chip_smoke.chronos_bound(16, 577, 12, 64, torch.zeros(16, 577, dtype=torch.int32), torch.float32,
                                         backward=False, three_tf32=True)
    flops = 4 * 64 * 12 * 16 * 577 * 577
    assert by == "operations" and math.isclose(bound, 3 * flops / 495e12 * 1e3)
