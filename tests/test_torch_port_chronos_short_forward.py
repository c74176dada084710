"""B4f's persistent one-pass route, against the JAX package.

The route (``csrc/chronos_attention_short_hopper.cu``: bf16, head_dim 64, up to 128 tokens)
runs only on the card; ``chip_smoke.py`` holds it against the
plain version there. What can be checked here is its arithmetic and its partition of the
work: the model below repeats, in PyTorch on the CPU, the order in which the kernel computes
and rounds, block by block, and is held against JAX's ``fused_chronos_attention`` forward
(the Pallas kernel in interpret mode, as the JAX package's own tests run it) within the
tolerance ``chip_smoke.py`` holds the kernel to (``KERNEL_TOL`` in bf16: 1e-2 + 1e-2
|reference|) on every element.

- Blocks: P blocks a head (132 // H on an H100 at one block an SM, at most B), block p of a
  head owning batch rows [p B / P, (p + 1) B / P); up to 80 tokens its two consumer groups
  take every other row of the range, from 81 one group takes them all.
- A row: the logits start from the bias, plus Q K^T in fp32; keys of another segment at
  finfo(float32).min; the whole key row is one tile, so the row max m and sum s are exact
  before any exponential; W = exp(l - m) (1 / s) is rounded to bf16 once normalised (JAX's
  ``w.astype(vs.dtype)``), times V summed in fp32, the output cast once.
"""

import functools
import re
from pathlib import Path

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
from tests.test_torch_port_short_backward import SMS, _excess, _segments

BF16 = torch.bfloat16
HEADS, DIM = 2, 64
BATCH = 3
CSRC = Path(tca.__file__).resolve().parent.parent / "csrc"


def partition(batch, heads, seq=67):
    """The route's blocks: (head, batch range, each consumer group's rows) for each of H x P
    blocks."""
    blocks = max(1, min(batch, SMS // heads))
    groups = 2 if seq <= 80 else 1
    out = []
    for h in range(heads):
        for p in range(blocks):
            b0, b1 = p * batch // blocks, (p + 1) * batch // blocks
            out.append((h, (b0, b1), [list(range(b0 + grp, b1, groups)) for grp in range(groups)]))
    return out


def persistent_forward(qkv, seg, bias, heads, dim):
    """B4f on the persistent route in its rounding order, block by block: (B, S, H*D) in qkv's
    dtype."""
    batch, seq, _ = qkv.shape
    q, k, v = split_heads(qkv, heads, dim)
    out = torch.full((batch, seq, heads, dim), float("nan"))
    for h, _, groups in partition(batch, heads, seq):
        for rows in groups:
            for b in rows:
                logits = bias[h] + q[b, :, h].float() @ k[b, :, h].float().T
                logits = logits.masked_fill(seg[b, :, None] != seg[b, None, :], NEG_INF)
                m = logits.amax(-1, keepdim=True)
                e = torch.exp(logits - m)
                w = (e * (1 / e.sum(-1, keepdim=True))).to(BF16).float()
                out[b, :, h] = w @ v[b, :, h].float()
    return out.flatten(-2).to(qkv.dtype)


def _case(seq, kind, seed=0):
    rng = np.random.default_rng(seed + seq)
    qkv = (rng.normal(size=(BATCH, seq, 3 * HEADS * DIM)) / DIM ** 0.25).astype(np.float32)
    bias = rng.normal(size=(HEADS, seq, seq)).astype(np.float32)
    seg = _segments(rng, kind, BATCH, seq)
    return qkv, seg, bias


@functools.cache
def _jax_forward(seq, kind):
    qkv, seg, bias = _case(seq, kind)
    out = j_chronos(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(seg),
                    make_rowtile_bias(jnp.asarray(bias), BATCH, seq), HEADS, DIM, True)
    return np.asarray(jnp.asarray(out, jnp.float32))


@pytest.mark.parametrize("kind", ["one", "several", "sixteen", "padded"])
@pytest.mark.parametrize("seq", [16, 64, 67, 80, 96, 128])
def test_persistent_forward_matches_jax(seq, kind):
    """S = 16, 64, 80 and 96 fill their 16-row tiles; 67 leaves 13 padded rows and keys (72
    keys computed). One, three and sixteen segments a row, and three with a fifth of the
    tokens padded, each with an id of its own."""
    qkv, seg, bias = _case(seq, kind)
    out = persistent_forward(torch.from_numpy(qkv).to(BF16), torch.from_numpy(seg), torch.from_numpy(bias),
                             HEADS, DIM)
    assert out.dtype == BF16 and out.shape == (BATCH, seq, HEADS * DIM)
    assert _excess(out, _jax_forward(seq, kind)) <= 0


def test_persistent_forward_matches_the_plain_version():
    """The card holds the kernel to the plain version: the model's order stays within the
    tolerance of it too, here at S = 67 with padded tokens."""
    qkv, seg, bias = (torch.from_numpy(x) for x in _case(67, "padded"))
    qkv = qkv.to(BF16)
    model = persistent_forward(qkv, seg, bias, HEADS, DIM).float()
    plain = tca.plain_chronos_attention(qkv, seg, bias).float()
    assert float(((model - plain).abs() - 1e-2 - 1e-2 * plain.abs()).max()) <= 0


@pytest.mark.parametrize("heads", [12, 6])
def test_partition_covers_every_row_once_at_batch_128(heads):
    """Chronos-2's fine-tune batch of 128 rows at 12 heads (11 blocks a head, 11 or 12 rows a
    block) and at 6 (22 blocks, 5 or 6 rows): every (head, batch row) once, each block one
    head and a contiguous range, each group's rows in increasing order."""
    seen = []
    blocks = partition(128, heads)
    assert len(blocks) == heads * (SMS // heads)
    for h, (b0, b1), groups in blocks:
        assert b1 - b0 in ((11, 12) if heads == 12 else (5, 6))
        assert sorted(groups[0] + groups[1]) == list(range(b0, b1))
        assert all(rows == sorted(rows) for rows in groups)
        seen += [(h, b) for b in range(b0, b1)]
    assert sorted(seen) == [(h, b) for h in range(heads) for b in range(128)]


def test_partition_with_fewer_rows_than_blocks():
    """Three batch rows at 12 heads: three blocks a head, one row each (group 1 idle); past 80
    tokens one group a block."""
    blocks = partition(3, 12)
    assert len(blocks) == 36 and all(b1 - b0 == 1 and groups[1] == [] for _, (b0, b1), groups in blocks)
    assert all(len(groups) == 1 and groups[0] == list(range(b0, b1))
               for _, (b0, b1), groups in partition(128, 12, seq=97))


def test_rule_border_agrees_with_the_wgmma_route():
    """The rule gives the persistent route S <= kShortFwdTo (the longest it is built for, 128)
    and the wgmma route S >= kFwdFrom: the two borders meet."""
    short = (CSRC / "chronos_attention_short_hopper.cu").read_text()
    wgmma = (CSRC / "chronos_attention_hopper.cu").read_text()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const(short, "kShortFwdTo") + 1 == const(wgmma, "kFwdFrom")
    assert const(short, "kShortFwdTo") == 128


def test_chip_smoke_names_the_persistent_forward_route_and_its_gate_lines():
    """chip_smoke.py's kernels line gives B4f the persistent route's source and an entry of the
    route's own with its counted launches; its SASS check requires HMMA and UTMALDG in the
    route's kernel family (defined in that source, which the library builds); its [gate]
    lines time the route against the one-pass route up to 96 tokens and the wgmma route from
    97, which the library's route override still reaches."""
    import chip_smoke

    from multimodal_timesfm_torch.ops import _kernels

    sources = {key: Path(cu).name for key, _, cu, *_ in chip_smoke.KERNELS}
    assert sources["B4f"] == "chronos_attention_short_hopper.cu"
    assert CSRC / "chronos_attention_short_hopper.cu" in _kernels.SOURCES
    assert "chronos_fwd_short_kernel" in chip_smoke.PERSISTENT_FAMILIES
    assert "    chronos_fwd_short_kernel(" in (CSRC / sources["B4f"]).read_text()
    shape = (128, 67, 12, 64)
    rows = {chip_smoke.row_key("B4f", shape, torch.bfloat16): {"ms": 1.0},
            chip_smoke.row_key("B1f", (64, 16, 16, 80), torch.bfloat16): {"ms": 2.0}}
    entries = chip_smoke.persistent_route_entries(rows, {"B4f persistent": 7, "B4f wgmma": 3})
    assert [(e["name"], e["launches"], e["ms"]) for e in entries] == [
        ("fused_chronos_attention (persistent route)", 7, 1.0),
        ("fused_qkv_causal_attention (persistent route)", 0, 2.0)]
    assert Path(entries[0]["source"]).name == "chronos_attention_short_hopper.cu"
    assert entries[0]["replaces"].endswith("ops/chronos_attention.py:120")
    assert chip_smoke.FORWARD_BORDER_LENGTHS == (16, 32, 48, 64, 67, 80, 96, 97, 113, 128)
    assert set(_kernels.ROUTE_NAMES) == {"rule", "mma.sync", "wgmma", "cuda cores", "tf32 mma.sync", "tf32 wgmma"}
    assert chip_smoke.B4_ROUTES[4] == "persistent" and "B4f" in chip_smoke.ROUTED_KEYS
