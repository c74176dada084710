"""Route 5 of the causal kernels B1-B3 (fp32, head_dim 80, 3xTF32 on wgmma fed by TMA), against JAX.

The route (``csrc/attention_fwd_tf32_hopper.cu``, ``csrc/attention_bwd_tf32_hopper.cu``, their
pieces in ``csrc/attention_tf32_hopper.cuh``) runs only on the card; ``chip_smoke.py`` holds it
against the plain versions there. Here the model below repeats, in PyTorch on the CPU, what its
kernels compute and in which order, and is held against JAX's ``fused_qkv_causal_attention`` (B1)
and ``fused_causal_attention`` (B2) in fp32 (the Pallas kernels in interpret mode, as the JAX
package's own tests run them) and their VJPs, within ``KERNEL_TOL`` and ``BWD_TOL``:

- The products: ``tests/test_torch_tf32_model.py``'s ``wgmma3`` (each operand split by truncation,
  hi = trunc(x), lo = tf32(x - hi), in shared memory by the producers' converting warps and in
  registers alike; lo hi, hi lo, hi hi per k-step of 8). The k order inside a k-step of P X (the rows of X^T stored 0, 2, 4, 6, 1, 3,
  5, 7) sums the same 8 products, which the model sums exactly.
- Tiles: 64 resident rows a warpgroup (query rows, or keys in the dK/dV kernel; the forward's
  blocks hold two such warpgroups), 32 rows a walked tile. The forward's warpgroups and the row
  kernels walk the 32-key tiles of the skip rule (``key_tiles``) from their 64 query rows; the
  dK/dV kernel the 32-row query tiles that meet its 64 keys (``query_tiles``).
- Forward: one pass, the online softmax (running max from finfo.min, sum and output rescaled).
- Backward: a statistics kernel (m, 1 / s and r = t / s per row, from S = Q K^T and dW = G V^T),
  a dQ kernel (dL = exp(l - m) / s (dW - r), dQ += dL K) and a dK/dV kernel (S^T = K Q^T, dW^T =
  V G^T, W^T and dL^T from the rows' statistics, dV += W^T G, dK += dL^T Q), with no scratch
  beyond the statistics. A row with no valid key has m = finfo.min, so its W is 1 / S at every
  key, above the diagonal too, which the query walk reaches.
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
from multimodal_timesfm_tpu.ops.attention import fused_causal_attention as j_fused
from multimodal_timesfm_tpu.ops.qkv_attention import fused_qkv_causal_attention as j_fused_qkv
from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops import attention as tattn
from tests.test_torch_port_causal_tf32 import (
    _excess,
    _mask,
    _sees_a_key,
    _tile,
    first_valid,
    key_tiles,
    query_tiles,
)
from tests.test_torch_tf32_model import CSRC, const, mma3, tf32, tf32_trunc, wgmma3

HEADS, DIM, BATCH = 2, 80, 3
KERNEL_TOL = chip_smoke.KERNEL_TOL[torch.float32]
BWD_TOL = chip_smoke.BWD_TOL[torch.float32]
FMAX = torch.finfo(torch.float32).max

_HEADER = (CSRC / "attention_tf32_hopper.cuh").read_text()
_FWD = (CSRC / "attention_fwd_tf32_hopper.cu").read_text()
_BWD = (CSRC / "attention_bwd_tf32_hopper.cu").read_text()
RES = const("kRes", _HEADER)  # rows of a resident tile
STR = const("kStr", _HEADER)  # rows of a walked tile
# The lengths from the border on (128, both ways: the dispatch rule's, set by chip_smoke.py's
# [gate] causal fp32 lines), B1's below 256 tokens and B2's from 256.
LENGTHS = (128, 192, 256, 512)


# ------------------------------------------------------------------ the model


def w_forward(q, k, v, valid, terms=3):
    """The forward on route 5 in its order: (B, S, H, D) fp32."""
    batch, seq = q.shape[:2]
    out = torch.zeros(q.shape)
    for b in range(batch):
        for q0 in range(0, seq, RES):
            qlast = min(q0 + RES, seq) - 1
            qq = _tile(q, b, q0, RES)
            m = torch.full(qq.shape[:2], -FMAX)
            s = torch.zeros(qq.shape[:2])
            o = torch.zeros(qq.shape)
            for t in key_tiles(q0, qlast, first_valid(valid[b], qlast + 1), seq, STR):
                k0 = t * STR
                kk, vv = _tile(k, b, k0, STR), _tile(v, b, k0, STR)
                sc = wgmma3(torch.zeros(HEADS, qq.shape[1], kk.shape[1]), qq, kk.transpose(-1, -2), terms)
                sc = _mask(sc, q0, k0, valid[b, k0:k0 + STR])
                nm = torch.maximum(m, sc.amax(-1))
                scale = torch.exp(m - nm)
                p = torch.exp(sc - nm[..., None])
                s = s * scale + p.sum(-1)
                o = wgmma3(o * scale[..., None], p, vv, terms)
                m = nm
            out[b, q0:q0 + RES] = (o * (1 / s)[..., None]).transpose(0, 1)
    return out


def w_backward(q, k, v, valid, g, terms=3):
    """The backward on route 5 in its order: (dq, dk, dv), each (B, S, H, D) fp32; the three
    kernels in turn, the statistics between them in a (B, H, S) array (zeros past S)."""
    batch, seq = q.shape[:2]
    stats = torch.zeros(3, batch, HEADS, seq)  # m, 1 / s, r
    dq, dk, dv = (torch.zeros(q.shape) for _ in range(3))

    def row_walk(b, q0):
        qlast = min(q0 + RES, seq) - 1
        qq, gg = _tile(q, b, q0, RES), _tile(g, b, q0, RES)
        for t in key_tiles(q0, qlast, first_valid(valid[b], qlast + 1), seq, STR):
            k0 = t * STR
            kk, vv = _tile(k, b, k0, STR), _tile(v, b, k0, STR)
            sc = wgmma3(torch.zeros(HEADS, qq.shape[1], kk.shape[1]), qq, kk.transpose(-1, -2), terms)
            dw = wgmma3(torch.zeros(HEADS, qq.shape[1], kk.shape[1]), gg, vv.transpose(-1, -2), terms)
            yield _mask(sc, q0, k0, valid[b, k0:k0 + STR]), dw, kk

    for b in range(batch):  # kernel 1: the statistics
        for q0 in range(0, seq, RES):
            rows = min(RES, seq - q0)
            m = torch.full((HEADS, rows), -FMAX)
            s = torch.zeros(HEADS, rows)
            t_ = torch.zeros(HEADS, rows)
            for sc, dw, _ in row_walk(b, q0):
                nm = torch.maximum(m, sc.amax(-1))
                scale = torch.exp(m - nm)
                e = torch.exp(sc - nm[..., None])
                s = s * scale + e.sum(-1)
                t_ = t_ * scale + (e * dw).sum(-1)
                m = nm
            stats[:, b, :, q0:q0 + rows] = torch.stack((m, 1 / s, t_ / s))
    for b in range(batch):  # kernel 2: dQ
        for q0 in range(0, seq, RES):
            rows = slice(q0, q0 + RES)
            m, inv, r = (x[b, :, rows, None] for x in stats)
            acc = torch.zeros(HEADS, min(RES, seq - q0), DIM)
            for sc, dw, kk in row_walk(b, q0):
                dl = torch.exp(sc - m) * inv * (dw - r)
                acc = wgmma3(acc, dl, kk, terms)
            dq[b, rows] = acc.transpose(0, 1)
    for b in range(batch):  # kernel 3: dK and dV
        f = first_valid(valid[b], seq)
        for k0 in range(0, seq, RES):
            klast = min(k0 + RES, seq) - 1
            kk, vv = _tile(k, b, k0, RES), _tile(v, b, k0, RES)
            keys = torch.arange(k0, klast + 1)[:, None]
            key_on = valid[b, k0:klast + 1][:, None]
            adk = torch.zeros(kk.shape)
            adv = torch.zeros(kk.shape)
            for qt in query_tiles(k0, klast, f, seq, STR):
                q0 = qt * STR
                qq, gg = _tile(q, b, q0, STR), _tile(g, b, q0, STR)
                cols = slice(q0, q0 + qq.shape[1])
                sct = wgmma3(torch.zeros(HEADS, kk.shape[1], qq.shape[1]), kk, qq.transpose(-1, -2), terms)
                dwt = wgmma3(torch.zeros(HEADS, kk.shape[1], qq.shape[1]), vv, gg.transpose(-1, -2), terms)
                queries = torch.arange(q0, q0 + qq.shape[1])[None, :]
                sct = torch.where((keys > queries) | ~key_on, torch.tensor(-FMAX), sct)
                m, inv, r = (x[b, :, None, cols] for x in stats)
                wt = torch.exp(sct - m) * inv
                dlt = wt * (dwt - r)
                adv = wgmma3(adv, wt, gg, terms)
                adk = wgmma3(adk, dlt, qq, terms)
            dk[b, k0:klast + 1] = adk.transpose(0, 1)
            dv[b, k0:klast + 1] = adv.transpose(0, 1)
    return dq, dk, dv


# ------------------------------------------------------------------- inputs


def _case(seq, zero_g=False):
    """fp32 (B, S, 3 H D) qkv (q scaled by D^-1/2), the key mask (left pads in [0, S/2), row 0
    unpadded, the last batch row with no valid key) and a random cotangent on every row (with
    ``zero_g``: zero on the rows that see no key, as on the model path)."""
    rng = np.random.default_rng(seq + 20)
    qkv = rng.normal(size=(BATCH, seq, 3 * HEADS * DIM)).astype(np.float32)
    qkv[..., : HEADS * DIM] /= np.sqrt(DIM)
    pads = rng.integers(0, seq // 2, size=BATCH)
    pads[0] = 0
    valid = np.arange(seq)[None, :] >= pads[:, None]
    valid[-1] = False
    g = rng.normal(size=(BATCH, seq, HEADS * DIM)).astype(np.float32)
    if zero_g:
        g *= _sees_a_key(valid)[..., None]
    return qkv, valid, g


def _heads(qkv):
    return tuple(torch.from_numpy(x).unflatten(-1, (HEADS, DIM)) for x in np.split(qkv, 3, axis=-1))


@functools.cache
def _jax(seq, zero_g=False):
    """JAX's forward and VJP at the case: B1's fused-qkv kernel below 256 tokens, B2's
    whole-sequence kernel from 256."""
    qkv, valid, g = _case(seq, zero_g)
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
def _model(seq, terms=3, zero_g=False):
    qkv, valid, g = _case(seq, zero_g)
    q, k, v = _heads(qkv)
    valid_t = torch.from_numpy(valid)
    gg = torch.from_numpy(g).unflatten(-1, (HEADS, DIM))
    return w_forward(q, k, v, valid_t, terms), w_backward(q, k, v, valid_t, gg, terms)


# -------------------------------------------------------------------- tests


@pytest.mark.parametrize("seq", LENGTHS)
def test_forward_matches_jax(seq):
    """128 and 192 tokens against JAX's fused-qkv kernel on every row that sees a key (it packs
    batch rows into one tile, so a row that sees none spreads over other rows' keys); 256 and 512
    against JAX's whole-sequence kernel on every row, the batch row with no valid key included;
    and the model against the plain version (the card's check) on every row."""
    qkv, valid, _ = _case(seq)
    out = _model(seq)[0]
    ref = _jax(seq)[0]
    rows = _sees_a_key(valid) if seq < 256 else None
    assert _excess(out, ref, KERNEL_TOL, rows) <= 0
    plain = tattn.plain_causal_attention(*_heads(qkv), torch.from_numpy(valid))
    assert _excess(out, plain, KERNEL_TOL) <= 0
    assert torch.equal(out[-1], plain[-1]) or _excess(out[-1], plain[-1], KERNEL_TOL) <= 0


@pytest.mark.parametrize("seq", LENGTHS)
def test_backward_matches_jax(seq):
    """dq, dk and dv, a random cotangent on every row, against the plain version (the card's
    check) on every element and JAX's VJP: from 256 tokens on every element; below it dq on the
    rows that see a key, and the whole backward again with the cotangent zero on the rows that
    see none (the model path's)."""
    qkv, valid, g = _case(seq)
    outs = _model(seq)[1]
    refs = _jax(seq)[1]
    plain = tattn.plain_attention_bwd(*_heads(qkv), torch.from_numpy(valid),
                                      torch.from_numpy(g).unflatten(-1, (HEADS, DIM)))
    for out, ref, p in zip(outs, refs, plain):
        assert _excess(out, p, BWD_TOL) <= 0
        if seq >= 256:
            assert _excess(out, ref, BWD_TOL) <= 0
    if seq < 256:
        assert _excess(outs[0], refs[0], BWD_TOL, _sees_a_key(valid)) <= 0
        for out, ref in zip(_model(seq, zero_g=True)[1], _jax(seq, zero_g=True)[1]):
            assert _excess(out, ref, BWD_TOL) <= 0


def test_the_row_with_no_valid_key_gets_uniform_weights():
    """The last batch row has no valid key: every query row of it weighs all S keys by 1 / S
    in the forward (its output is the mean of V over the keys), and its dK is zero where its
    dL^T = W (dW - r) sums to zero over the rows' cotangent (r is the row's mean of dW)."""
    seq = 128
    qkv, valid, _ = _case(seq)
    q, k, v = _heads(qkv)
    out = _model(seq)[0]
    mean_v = v[-1].mean(0, keepdim=True).expand(seq, HEADS, DIM)
    assert _excess(out[-1], mean_v, KERNEL_TOL) <= 0


@pytest.mark.parametrize("seq", [128, 512])
def test_one_tf32_product_misses_the_fp32_tolerance(seq):
    """hi hi alone (operands truncated to TF32: 2^-10 relative) leaves the forward outside
    KERNEL_TOL and the backward outside BWD_TOL of the plain version: hence three."""
    qkv, valid, g = _case(seq)
    fwd, bwd = _model(seq, terms=1)
    q, k, v = _heads(qkv)
    plain = tattn.plain_causal_attention(q, k, v, torch.from_numpy(valid))
    plain_b = tattn.plain_attention_bwd(q, k, v, torch.from_numpy(valid),
                                        torch.from_numpy(g).unflatten(-1, (HEADS, DIM)))
    assert _excess(fwd, plain, KERNEL_TOL) > 0
    assert max(_excess(o, p, BWD_TOL) for o, p in zip(bwd, plain_b)) > 0


def test_the_split_by_truncation():
    """hi = trunc(x) is what the tensor cores read of x as stored; lo = tf32(x - hi) is the
    kernel's lo_bits (x - hi plus half a TF32 ulp, read truncated): x - hi - lo within 2^-21 |x|,
    twice route 4's bound (2^-22, hi rounded to nearest), and a product's three terms within
    2^-20 of it."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=100000).astype(np.float32)) * 1e3
    hi = tf32_trunc(x)
    lo = tf32(x - hi)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros_like(hi, dtype=torch.int32))
    assert bool(((x.double() - hi.double() - lo.double()).abs() <= 2.0 ** -21 * x.double().abs()).all())
    assert "return __float_as_uint(x - hi) + 0x1000u;" in _HEADER
    assert "__float_as_uint(x) & 0xffffe000u" in _HEADER
    a, b = (torch.from_numpy(np.random.default_rng(s).normal(size=(64, 80)).astype(np.float32)) for s in (2, 3))
    exact = a.double() @ b.double().T
    err = (wgmma3(torch.zeros(64, 64), a, b.T) - exact).abs().max().item()
    one = (mma3(torch.zeros(64, 64), a, b.T, terms=1) - exact).abs().max().item()
    assert err < 1e-5 * exact.abs().max().item() and one > 100 * err


def test_tiles_descriptors_and_the_transposed_order():
    """The tiles (64 resident rows, 32 walked), the TMA boxes (32 and 16 fp32 columns, 128- and
    64-byte swizzle), the k-steps of 8 (ten over head_dim 80, four over a walked tile), the
    products' order (lo hi, hi lo, hi hi), and X^T's row order within each 8: positions 0-3
    hold rows 0, 2, 4, 6 and 4-7 rows 1, 3, 5, 7, the order in which an accumulator's thread
    holds the columns of a k-step (2t as k = t, 2t + 1 as k = t + 4)."""
    assert (const("kD", _HEADER), RES, STR) == (80, 64, 32)
    rows_of = []
    for j in range(8):  # convert_t's chunk j of a row of X^T: rows 8 (j / 2) + (j % 2) + 2 e
        rows_of += [8 * (j >> 1) + (j & 1) + 2 * e for e in range(4)]
    assert rows_of[:8] == [0, 2, 4, 6, 1, 3, 5, 7] and sorted(rows_of) == list(range(32))
    lanes = [(g, t) for g in range(8) for t in range(4)]
    # acc_frags: a0..a3 = x[kk][0], x[kk][2], x[kk][1], x[kk][3]: (row g, k t) is column 2t, (g, k t + 4) column 2t + 1
    for g, t in lanes:
        assert rows_of[t] == 2 * t and rows_of[t + 4] == 2 * t + 1
    assert "const float a[4] = {x[kk][0], x[kk][2], x[kk][1], x[kk][3]};" in _HEADER
    assert "const int k0 = 8 * (j >> 1) + (j & 1);" in _HEADER
    issue = re.search(r"void issue_abt3\(.*?\n}\n", _HEADER, re.S).group(0)
    calls = re.findall(r"wgmma_tf32_ss32\(acc, (.*)\);", issue)  # lo hi, hi lo, hi hi
    assert calls == ["nat_desc<kRes>(a_lo, kk), bh, kk > 0", "ah, nat_desc<kStr>(b_lo, kk), 1", "ah, bh, 1"]
    pb = re.search(r"void issue_pb3\(.*?\n}\n", _HEADER, re.S).group(0)
    assert re.findall(r"wgmma_tf32_rs80\(out, (.*)\);", pb) == ["lo[kk], th", "hi[kk], t_desc(t_lo, kk)", "hi[kk], th"]
    assert "m64n32k8.f32.tf32.tf32" in (CSRC / "hopper_common.cuh").read_text()
    assert "m64n80k8.f32.tf32.tf32" in (CSRC / "hopper_common.cuh").read_text()
    assert "CU_TENSOR_MAP_DATA_TYPE_FLOAT32" in (CSRC / "hopper_common.cuh").read_text()


@pytest.mark.parametrize("batch,seq,heads", [(16, 512, 16), (2, 2100, 16), (1, 20000, 16)])
def test_the_scratch_is_three_floats_a_row_with_no_length_cap(batch, seq, heads):
    """Route 5's backward keeps only the row statistics (3 B H Sp floats, Sp = S rounded up to
    64), where route 4 keeps W and dL by the causal triangle (about half of B H S^2 8 bytes) and
    stops at 16,320 tokens; the route's rule has no upper border."""
    sp = -(-seq // 64) * 64
    assert 3 * batch * heads * sp * 4 < 0.01 * batch * heads * seq * seq * 8 / 2 or seq < 600
    takes = re.search(r'int tf32w_bwd_takes\(int S, int D\) \{.*?\n}\n', _BWD, re.S).group(0)
    assert "kScratch" not in takes and "return force == 5 || S >= kBwdFrom;" in takes
    bwd_c = (CSRC / "attention_bwd.cu").read_text()
    assert "return 3LL * B * H * ((S + 63) / 64 * 64);" in bwd_c
    assert "if (dtype == 0 && !tf32w && tf32_bwd_takes(S, D) &&" in bwd_c


def test_dispatch_borders_and_the_python_rule_follow_the_sources():
    """Route 5 ahead of route 4 in both dispatches; its borders the constants the [gate] lines
    set (kFwdFrom, kBwdFrom), which ``_kernels.TF32_WGMMA_FROM`` repeats; the override's "tf32
    mma.sync" (4) keeps fp32 off route 5 and "tf32 wgmma" (5) puts it there at every S."""
    assert _kernels.TF32_WGMMA_FROM == {"forward": const("kFwdFrom", _FWD), "backward": const("kBwdFrom", _BWD)}
    assert _kernels.ROUTE_NAMES["tf32 mma.sync"] == 4 and _kernels.ROUTE_NAMES["tf32 wgmma"] == 5
    assert "3xTF32 wgmma" in _kernels._ROUTES[5] and "3xTF32 mma.sync" in _kernels._ROUTES[4]
    fwd_c = (CSRC / "attention_fwd.cu").read_text()
    bwd_c = (CSRC / "attention_bwd.cu").read_text()
    assert fwd_c.index("if (tf32w_fwd_takes(S, D) && tf32w_fwd_layout(") < fwd_c.index(
        "if (tf32_fwd_takes(D) && tf32_fwd_layout(")
    assert bwd_c.index("return tf32w_attention_bwd(") < bwd_c.index("return tf32_attention_bwd(")
    for src in (_FWD, _BWD):
        assert "if (D != kD || force == 3 || force == 4) return 0;" in src
    for name in ("attention_fwd_tf32_hopper.cu", "attention_bwd_tf32_hopper.cu"):
        assert CSRC / name in _kernels.SOURCES
        src = (CSRC / name).read_text()
        assert '#include "attention_tf32_hopper.cuh"' in src and "issue_abt3(" in src and "issue_pb3(" in src
        assert "load_f32_tile<" in src and not re.search(r"cublas|cudnn|#include <torch|#include <ATen", src, re.I)


def test_chip_smoke_gates_and_counts_the_route():
    """chip_smoke.py times route 4 against route 5 in its [gate] causal fp32 lines, requires
    HGMMA on TF32 operands and UTMALDG in every route-5 instantiation, and counts route 5's
    launches apart ("tf32 wgmma")."""
    assert set(chip_smoke.TF32W_FAMILIES) == {"attention_fwd_tf32w_kernel", "attention_bwd_rows_tf32w_kernel",
                                              "attention_bwd_dkdv_tf32w_kernel"}
    for family in chip_smoke.TF32W_FAMILIES:
        assert f"    {family}(" in _FWD + _BWD
    assert chip_smoke.B1_ROUTES[5] == "tf32 wgmma"
    gate = inspect.getsource(chip_smoke.causal_f32_borders)
    assert '"tf32 mma.sync"' in gate and '"tf32 wgmma"' in gate and "cuda cores" not in gate
