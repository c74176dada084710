"""More than 65,535 batch rows (C3): the entry points run the batch in chunks.

Several routes lay the batch on the CUDA grid's y or z dimension, which stops at 65,535, so the
library's four entry points (``attention_fwd``, ``attention_bwd``, ``chronos_attention_fwd``,
``chronos_attention_bwd``) run a larger batch as chunks of at most ``kGridRows`` rows, in order on
the caller's stream (``csrc/attention_common.cuh``); the Chronos dbias adds the chunks' sums in
batch order. JAX's grids are one-dimensional over the batch, with no such limit; under a trial
axis the port's vmap rule folds 16 trials of 4,096 series into 65,536 rows. The kernels run only
on the card (``chip_smoke.py``'s ``batch_chunk_checks`` holds B1-B4 at 65,537 rows to the plain
versions there); here the chunking is modelled and checked on meta tensors, and the chunked
composition is held against JAX.
"""

import functools
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
from multimodal_timesfm_torch.ops import qkv_attention as tqa
from tests.test_torch_port_short_backward import _segments
from tests.test_torch_tf32_model import CSRC, const

COMMON = (CSRC / "attention_common.cuh").read_text()
GRID_ROWS = const("kGridRows", COMMON)
BWD_TOL = chip_smoke.BWD_TOL[torch.float32]


def grid_chunk_rows(batch: int, most: int = GRID_ROWS) -> int:
    """``mtt::grid_chunk_rows``: as few chunks as keep each within ``most`` rows, as even as
    their count allows."""
    chunks = -(-batch // most)
    return -(-batch // chunks)


def chunks(batch: int, most: int = GRID_ROWS) -> list[tuple[int, int]]:
    """(first row, rows) of each chunk, as the entry points' loops take them."""
    rows = grid_chunk_rows(batch, most)
    return [(b0, min(rows, batch - b0)) for b0 in range(0, batch, rows)]


def test_the_grid_limit_and_the_chunk_rule_are_the_sources():
    assert GRID_ROWS == 65535
    assert "const int chunks = (B + kGridRows - 1) / kGridRows;\n  return (B + chunks - 1) / chunks;" in COMMON


@pytest.mark.parametrize("batch", [1, 65535, 65536, 65537, 131070, 131071, 200000, 1 << 20])
def test_chunks_cover_the_batch_in_order_within_the_grid(batch):
    parts = chunks(batch)
    assert [b for b0, n in parts for b in range(b0, b0 + n)] == list(range(batch))
    assert all(0 < n <= GRID_ROWS for _, n in parts)
    assert len(parts) == -(-batch // GRID_ROWS)  # as few as the limit allows
    assert max(n for _, n in parts) - min(n for _, n in parts) < len(parts)  # as even as their count allows
    if batch <= GRID_ROWS:
        assert parts == [(0, batch)]  # no chunking, the parent's launches unchanged


def test_every_entry_point_lifts_the_batch_limit_and_keeps_the_heads_one():
    """The four entry points refuse H > 65,535 (a grid dimension of its own) but no batch size;
    each runs more than kGridRows rows through its own chunk loop."""
    texts = {name: (CSRC / name).read_text() for name in
             ("attention_fwd.cu", "attention_bwd.cu", "chronos_attention.cu", "chronos_attention_bwd.cu",
              "chronos_common.cuh")}
    for name, text in texts.items():
        assert "B > 65535" not in text, name
    assert "|| H > 65535" in texts["attention_fwd.cu"] and "|| H > 65535" in texts["attention_bwd.cu"]
    assert "D > kMaxDim || H > 65535;" in texts["chronos_common.cuh"]
    for name in ("attention_fwd.cu", "attention_bwd.cu", "chronos_attention.cu", "chronos_attention_bwd.cu"):
        assert "const int rows = mtt::grid_chunk_rows(B);" in texts[name], name
        assert "for (int b0 = 0; b0 < B; b0 += rows) {" in texts[name], name
    assert "if (B > mtt::kGridRows) {" in texts["attention_fwd.cu"]
    assert "if (B > mtt::kGridRows) {" in texts["attention_bwd.cu"]


@pytest.mark.parametrize("dtype,elt", [(torch.float32, 4), (torch.bfloat16, 2)])
def test_chunk_offsets_on_meta_tensors(dtype, elt):
    """The byte offsets the entry points move each operand by (b0 S x the row's bytes; the
    Chronos ones: qkv 3 S H D, out and g S H D, seg 4 S) are where a chunk's first row lies:
    on meta tensors of 65,537 rows (two chunks), a meta tensor's data_ptr being its byte
    offset."""
    batch, seq, heads, dim = 65537, 16, 2, 64
    qkv = torch.empty(batch, seq, 3 * heads * dim, dtype=dtype, device="meta")
    seg = torch.empty(batch, seq, dtype=torch.int32, device="meta")
    out = torch.empty(batch, seq, heads * dim, dtype=dtype, device="meta")
    parts = chunks(batch)
    assert parts == [(0, 32769), (32769, 32768)]
    row = seq * heads * dim * elt  # chronos_attention.cu / chronos_attention_bwd.cu: S H D elt
    for b0, n in parts:
        assert qkv[b0:b0 + n].data_ptr() == 3 * row * b0
        assert out[b0:b0 + n].data_ptr() == row * b0
        assert seg[b0:b0 + n].data_ptr() == 4 * seq * b0
        assert qkv[b0:b0 + n].data_ptr() % 16 == 0  # TMA's and cp.async's alignment holds per chunk
    # The causal entry points: b0 S ld elt for q, k, v (ld the shared row stride), ld_g for g.
    q = qkv[..., : heads * dim].unflatten(-1, (heads, dim))
    ld = q.stride(1)
    for b0, n in parts:
        assert q[b0:b0 + n].data_ptr() == b0 * seq * ld * elt
    fwd = (CSRC / "attention_fwd.cu").read_text()
    assert "const long long in = (long long)b0 * S * ld_in * elt, to = (long long)b0 * S * ld_out * elt;" in fwd
    assert "mtt::byte_at(qkv, 3 * row * b0), mtt::byte_at(seg, 4LL * S * b0)" in (
        CSRC / "chronos_attention.cu").read_text()


def test_the_wrappers_hand_the_whole_batch_to_the_library(monkeypatch):
    """On meta tensors past 65,535 rows the ops reach the kernel entry with the whole batch
    (the chunks are the library's): the forward and backward of B1 and B4."""
    calls = []
    monkeypatch.setattr(_kernels, "chronos_attention_fwd", lambda qkv, *a: calls.append(("B4f", qkv.shape[0])))
    monkeypatch.setattr(_kernels, "chronos_attention_bwd", lambda qkv, *a: calls.append(("B4b", qkv.shape[0])))
    monkeypatch.setattr(_kernels, "attention_fwd", lambda q, *a: calls.append(("B1f", q.shape[0])))
    monkeypatch.setattr(_kernels, "attention_bwd", lambda q, *a: calls.append(("B1b", q.shape[0])))
    batch, seq, heads, dim = 65537, 16, 1, 64
    qkv = torch.empty(batch, seq, 3 * heads * dim, device="meta")
    seg = torch.empty(batch, seq, dtype=torch.int32, device="meta")
    bias = torch.empty(heads, seq, seq, device="meta")
    g = torch.empty(batch, seq, heads * dim, device="meta")
    tca.fused_chronos_attention(qkv, seg, bias)
    tca.fused_chronos_attention_bwd(qkv, seg, bias, g, True)
    valid = torch.empty(batch, seq, dtype=torch.bool, device="meta")
    tqa.fused_qkv_causal_attention(qkv, valid, heads, dim)
    tqa.fused_qkv_causal_attention_bwd(qkv, valid, g, heads, dim)
    assert sorted(calls) == sorted([("B4f", batch), ("B4b", batch), ("B1f", batch), ("B1b", batch)])


def test_chronos_dbias_adds_the_chunks_in_order():
    """chronos_attention_bwd: the first chunk writes dbias, each later one writes its own sum
    into the last plane of the partials and adds it (chronos_bwd_dbias_add_kernel), so dbias
    is ((chunk 0) + chunk 1) + ...: a fixed order, the same bits every launch; the buffers ask
    one plane more past kGridRows rows."""
    text = (CSRC / "chronos_attention_bwd.cu").read_text()
    entry = text[text.index('extern "C" int chronos_attention_bwd('):]
    assert "b0 == 0 ? dbias : own" in entry
    assert entry.index("bwd_rows(") < entry.index("chronos_bwd_dbias_add_kernel<<<")
    assert "if (e < n) dbias[e] += part[e];" in text
    assert "floats[1] = std::max(parts[0], parts[1]) + (rows < B ? (long long)H * S * S : 0);" in text


def _case(batch, seq, heads, dim, seed=3):
    rng = np.random.default_rng(seed)
    qkv = (rng.normal(size=(batch, seq, 3 * heads * dim)) / dim ** 0.25).astype(np.float32)
    bias = rng.normal(size=(heads, seq, seq)).astype(np.float32)
    seg = _segments(rng, "padded", batch, seq)
    g = rng.normal(size=(batch, seq, heads * dim)).astype(np.float32)
    return qkv, seg, bias, g


@functools.cache
def _jax(batch, seq, heads, dim):
    qkv, seg, bias, g = _case(batch, seq, heads, dim)
    out, vjp = jax.vjp(
        lambda t, b: j_chronos(t, jnp.asarray(seg), make_rowtile_bias(b, batch, seq), heads, dim, True),
        jnp.asarray(qkv), jnp.asarray(bias),
    )
    dqkv, dbias = vjp(jnp.asarray(g))
    return tuple(np.asarray(x, np.float32) for x in (out, dqkv, dbias))


@pytest.mark.parametrize("most", [2, 3, 7])
def test_chunked_composition_matches_jax(most):
    """The entry points' composition at a small limit: every chunk a call of its own (the
    plain versions stand for the routes here), the outputs row for row, dbias the chunks' sums
    added in order; against JAX's forward and VJP over the whole batch (7 rows: chunks of 2,
    3 or all 7), within the fp32 tolerances."""
    batch, seq, heads, dim = 7, 17, 2, 64
    qkv, seg, bias, g = (torch.from_numpy(x) for x in _case(batch, seq, heads, dim))
    outs, dqkvs, dbias = [], [], None
    for b0, n in chunks(batch, most):
        rows = slice(b0, b0 + n)
        outs.append(tca.plain_chronos_attention(qkv[rows], seg[rows], bias))
        dq, db = tca.plain_chronos_attention_bwd(qkv[rows], seg[rows], bias, g[rows], True)
        dqkvs.append(dq)
        dbias = db if dbias is None else dbias + db
    out, ref_dqkv, ref_dbias = _jax(batch, seq, heads, dim)
    for mine, ref, tol in ((torch.cat(outs), out, chip_smoke.KERNEL_TOL[torch.float32]),
                           (torch.cat(dqkvs), ref_dqkv, BWD_TOL), (dbias, ref_dbias, BWD_TOL)):
        err = np.abs(mine.numpy() - ref) - tol[0] - tol[1] * np.abs(ref)
        assert err.max() <= 0
    whole_dqkv, _ = tca.plain_chronos_attention_bwd(qkv, seg, bias, g, True)
    assert torch.allclose(torch.cat(dqkvs), whole_dqkv, rtol=1e-6, atol=1e-6)  # rows are independent


def test_chip_smoke_checks_65537_rows_of_every_family():
    shapes = dict(chip_smoke.BATCH_CHUNK_SHAPES)
    assert set(shapes) == {"B1", "B2", "B3", "B4"}
    assert all(shape[0] == 65537 > GRID_ROWS for shape in shapes.values())
    assert shapes["B4"][3] == 64 and shapes["B1"][3] == 80
    import inspect

    src = inspect.getsource(chip_smoke.batch_chunk_checks)
    assert "for dtype in (torch.float32, torch.bfloat16):" in src and "same_twice(" in src
    assert re.search(r"check_chronos\(what, qkv, seg, bias, g\)", src)
