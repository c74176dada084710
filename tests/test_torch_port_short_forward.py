"""B1f's persistent one-pass route, against the JAX package.

The route (``csrc/attention_fwd_short_hopper.cu``: bf16, head_dim 80, up to 64 tokens) runs
only on the card; ``chip_smoke.py`` holds it against the plain version there. What can be
checked here is its arithmetic and its partition of the work: the model below repeats, in
PyTorch on the CPU, the order in which the kernel computes and rounds, and is held against
JAX's ``fused_qkv_causal_attention`` forward (the Pallas kernel in interpret mode, as the JAX
package's own tests run it) within the tolerance ``chip_smoke.py`` holds the kernel to
(``KERNEL_TOL`` in bf16: 1e-2 + 1e-2 |reference|) on every element of every valid query row.

- A work item: one head of one batch row, all SP = S rounded up to 16 rows, one warp per 16
  query rows; persistent blocks, as many as an SM's shared memory holds, take items blockIdx,
  blockIdx + grid, ..., their two consumer groups every other one.
- A row: L = Q K^T in fp32; causal-future and padded keys at finfo(float32).min; the whole key
  row is one tile, so the row max m and sum s are exact before any exponential; W = exp(l - m)
  (1 / s) is rounded to bf16 once normalised (JAX's ``w.astype(v.dtype)``), times V summed in
  fp32, the output cast once.
- Padded query rows: a row with no valid key gets uniform weights over all S keys in the port,
  over the packed row tile in JAX's kernel (``ROADMAP.md`` §C's stated departure), so those
  rows are compared with the port's plain version only.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.ops.qkv_attention import fused_qkv_causal_attention as j_fused_qkv
from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops.attention import NEG_INF
from multimodal_timesfm_torch.ops.qkv_attention import plain_qkv_causal_attention, split_heads
from tests.test_torch_port_short_backward import ATOL, RTOL, SMS

BF16 = torch.bfloat16
HEADS, DIM = 2, 80
BATCH = 3
CSRC = Path(_kernels.__file__).resolve().parent.parent / "csrc"
SOURCE = (CSRC / "attention_fwd_short_hopper.cu").read_text()


def const(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def smem_bytes(seq):
    """The route's dynamic shared memory at S (its Cfg): the alignment slack, each stage's
    key-valid bytes and barriers, and as many stages of q, k and v tiles as fit, at most 6."""
    sp = 16 * -(-seq // 16)
    tile = -(-(sp * 2 * DIM) // 1024) * 1024
    stage = 3 * tile
    fixed = 1024 + 6 * sp + 16 * 6
    return fixed + min(6, (232448 - fixed) // stage) * stage


def blocks_per_sm(seq):
    """Blocks an H100 SM's 228 KB of shared memory holds (1 KB of it reserved a block)."""
    return 233472 // (smem_bytes(seq) + 1024)


def partition(batch, heads, seq, sms=SMS):
    """The route's work: for each block, each consumer group's (stage row j, item i, (batch
    row, head)) in order, at as many blocks an SM as its shared memory holds."""
    items = batch * heads
    grid = min(sms * blocks_per_sm(seq), items)
    blocks = []
    for block in range(grid):
        groups = []
        for grp in range(2):
            rows = [(grp + 2 * j, i, divmod(i, heads))
                    for j, i in enumerate(range(block + grp * grid, items, 2 * grid))]
            groups.append(rows)
        blocks.append((block, groups))
    return blocks


def persistent_forward(qkv, valid, heads, dim):
    """B1f on the persistent route in its rounding order: (B, S, H*D) in qkv's dtype."""
    batch, seq, _ = qkv.shape
    q, k, v = split_heads(qkv, heads, dim)
    causal = torch.ones(seq, seq, dtype=torch.bool).tril()
    out = torch.full((batch, seq, heads, dim), float("nan"))
    for b in range(batch):
        allowed = causal & valid[b][None, :]
        for h in range(heads):
            logits = (q[b, :, h].float() @ k[b, :, h].float().T).masked_fill(~allowed, NEG_INF)
            m = logits.amax(-1, keepdim=True)  # exact: every key of the row in one tile
            e = torch.exp(logits - m)
            w = (e * (1 / e.sum(-1, keepdim=True))).to(BF16).float()
            out[b, :, h] = w @ v[b, :, h].float()
    return out.flatten(-2).to(qkv.dtype)


def _case(seq, kind, seed=0):
    """B = 3 inputs from a seed, q pre-scaled: "full" (every key valid), "left" (left padding,
    row 1 padded past its first half so that its first query rows see no valid key) or
    "empty" (left padding with row 2 holding no valid key at all)."""
    rng = np.random.default_rng(seed + seq)
    hd = HEADS * DIM
    qkv = rng.normal(size=(BATCH, seq, 3 * hd)).astype(np.float32)
    qkv[..., :hd] /= np.sqrt(DIM)
    pads = np.zeros(BATCH, dtype=int)
    if kind != "full":
        pads = np.array([0, seq // 2 + 1, rng.integers(0, seq // 2 + 1)])
    valid = np.arange(seq)[None, :] >= pads[:, None]
    if kind == "empty":
        valid[2] = False
    return qkv, valid


def _valid_rows(valid):
    """(B, S) query rows with at least one valid key at or before them."""
    return np.cumsum(valid, axis=1) > 0


@functools.cache
def _jax_forward(seq, kind):
    qkv, valid = _case(seq, kind)
    out = j_fused_qkv(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(valid), HEADS, DIM, True)
    return np.asarray(jnp.asarray(out, jnp.float32))


def _excess(out, ref, rows):
    """max(|out - ref| - atol - rtol |ref|) over the query rows ``rows``: <= 0 within the
    tolerance on every element there."""
    out = out.float().numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    return float((np.abs(out - ref) - ATOL - RTOL * np.abs(ref))[rows].max())


@pytest.mark.parametrize("kind", ["full", "left", "empty"])
@pytest.mark.parametrize("seq", [8, 16, 32, 48, 64])
def test_persistent_forward_matches_jax(seq, kind):
    """S = 8 leaves 8 padded rows and keys in the route's 16-row tile; 16-64 fill theirs. Every
    valid query row of every case within the tolerance of JAX's kernel."""
    qkv, valid = _case(seq, kind)
    out = persistent_forward(torch.from_numpy(qkv).to(BF16), torch.from_numpy(valid), HEADS, DIM)
    assert out.dtype == BF16 and out.shape == (BATCH, seq, HEADS * DIM)
    rows = _valid_rows(valid)
    assert rows.all() == (kind == "full")
    assert _excess(out, _jax_forward(seq, kind), rows) <= 0


@pytest.mark.parametrize("seq", [8, 16, 64])
def test_persistent_forward_matches_the_plain_version_on_every_row(seq):
    """The card holds the kernel to the plain version on every row: rows with no valid key
    (row 1's first half, all of row 2) have uniform weights over all S keys in both."""
    qkv, valid = (torch.from_numpy(x) for x in _case(seq, "empty"))
    qkv = qkv.to(BF16)
    model = persistent_forward(qkv, valid, HEADS, DIM).float()
    plain = plain_qkv_causal_attention(qkv, valid, HEADS, DIM).float()
    assert float(((model - plain).abs() - ATOL - RTOL * plain.abs()).max()) <= 0
    # a row with no valid key: the mean of V over all S keys, in every head
    v = split_heads(qkv, HEADS, DIM)[2][2].float().mean(0).flatten()
    torch.testing.assert_close(model[2], v.expand(seq, -1), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("sms", [SMS, 114])
@pytest.mark.parametrize("batch,seq", [(64, 16), (256, 16), (64, 64), (3, 16), (2, 40)])
@pytest.mark.parametrize("heads", [16, 5])
def test_partition_covers_every_row_and_head_once(batch, seq, heads, sms):
    """At TimesFM's 16 heads (64 x 16: 1,024 items on 528 blocks of an H100 SXM's 132 SMs,
    four an SM; 256 x 16: 4,096; 64 x 64: 1,024 items on 132 blocks) and at 5 heads; batches of
    3 and 2 give fewer items than blocks. The grid follows the card's SM count, so an H100
    PCIe's 114 SMs too. Every (batch row, head) once; each group's rows are the producer's
    stage rows grp, grp + 2, ... with the producer's items blockIdx + j grid."""
    assert [blocks_per_sm(s) for s in (16, 32, 48, 64)] == [4, 2, 1, 1]
    blocks = partition(batch, heads, seq, sms)
    assert len(blocks) == min(sms * blocks_per_sm(seq), batch * heads)
    seen = []
    for block, groups in blocks:
        for grp, rows in enumerate(groups):
            for j, i, pair in rows:
                assert j % 2 == grp and i == block + j * len(blocks)
                seen.append(pair)
    assert sorted(seen) == [(b, h) for b in range(batch) for h in range(heads)]


@pytest.mark.parametrize("sp", [16, 32, 48, 64])
def test_stages_fit_and_hold_six_rows_at_every_length(sp):
    """The ring holds 6 stages at every S of each tile height SP up to 64 (the header's
    claim), within the 232,448 bytes a block can have, 1 KB-aligned tiles included."""
    tile = -(-(sp * 2 * DIM) // 1024) * 1024
    for seq in range(sp - 15, sp + 1):
        assert (smem_bytes(seq) - 1024 - 6 * sp - 96) == 6 * 3 * tile
        assert smem_bytes(seq) <= 232448


def test_rule_border_meets_the_wgmma_route_and_the_source_stands_alone():
    """The rule gives the persistent route 1 <= S <= kShortFwdTo (64, the longest it is built
    for) and the wgmma route S >= kFwdFrom: the two borders meet. The route is a
    source of the library, built from hopper_short.cuh's pieces, and calls no library
    attention and nothing of the JAX package; attention_fwd checks its rule ahead of the wgmma
    route's."""
    wgmma = (CSRC / "attention_fwd_hopper.cu").read_text()
    assert const(SOURCE, "kShortFwdTo") + 1 == const(wgmma, "kFwdFrom")
    assert const(SOURCE, "kShortFwdTo") == 64
    assert CSRC / "attention_fwd_short_hopper.cu" in _kernels.SOURCES
    assert '#include "hopper_short.cuh"' in SOURCE
    code = re.sub(r"//[^\n]*", "", SOURCE)
    assert not re.search(r"jax|cublas|cudnn|scaled_dot_product|#include <torch|#include <ATen", code, re.I)
    assert "force != 1 && force != 2" in SOURCE  # mma.sync and wgmma overrides keep it off
    dispatch = (CSRC / "attention_fwd.cu").read_text()
    body = dispatch[dispatch.index('extern "C" int attention_fwd('):]
    assert body.index("short_fwd_takes(S, D) && short_fwd_layout(") < body.index("hopper_fwd_takes(S, D) &&")


def test_chip_smoke_times_gates_and_counts_the_route():
    """chip_smoke.py's kernels line gives B1f's persistent route an entry of its own at 64 x 16
    with its counted launches; its SASS check requires HMMA and UTMALDG in the route's kernel
    family (defined in that source); its [gate] lines run S = 8-64 in steps of 8; the C++
    registration's checks launch it at 64 x 16."""
    import chip_smoke

    rows = {chip_smoke.row_key(key, shape, BF16): {"ms": float(i)}
            for i, (key, *_, shape) in enumerate(chip_smoke.PERSISTENT_KERNELS)}
    entries = chip_smoke.persistent_route_entries(rows, {"B1f persistent": 9, "B1f wgmma": 2})
    b1f = [e for e in entries if e["name"] == "fused_qkv_causal_attention (persistent route)"]
    assert len(b1f) == 1 and b1f[0]["launches"] == 9 and b1f[0]["shape"] == "B=64 S=16 H=16 D=80 bfloat16"
    assert Path(b1f[0]["source"]).name == "attention_fwd_short_hopper.cu"
    assert b1f[0]["replaces"].endswith("ops/qkv_attention.py:111")
    assert "attention_fwd_short_kernel" in chip_smoke.PERSISTENT_FAMILIES
    assert "    attention_fwd_short_kernel(" in SOURCE
    assert chip_smoke.SHORT_FORWARD_BORDER_LENGTHS == (8, 16, 24, 32, 40, 48, 56, 64)
    assert ("B1f", (64, 16, 16, 80)) in chip_smoke.NATIVE_CHECK_SHAPES
    assert sorted({seq for _, seq, _ in chip_smoke.SHORT_FORWARD_FUSED}) == list(range(8, 65, 8))
    assert chip_smoke.B1_ROUTES[3] == "persistent" and "B1f" in chip_smoke.ROUTED_KEYS
