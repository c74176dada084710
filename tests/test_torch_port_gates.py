"""The attention dispatch on the kernel route: every S >= 2 reaches a hand-written kernel.

Meta tensors stand in for CUDA ones (they take the kernel path; the launch
functions are replaced, so nothing runs). The fused-qkv kernel (B1) keeps
the TPU's border, 8 <= S < 256 with S % 8 == 0; the whole-sequence kernel
(B2) takes every other S up to 2,048; the flash entry point (B3) takes the
rest; the plain path runs for CPU tensors only.
"""

import numpy as np
import pytest
import torch

from multimodal_timesfm_torch.models import layers as tl
from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops import attention as tattn
from multimodal_timesfm_torch.ops import qkv_attention as tqkv


def _expected(seq):
    if seq == 1:
        return None
    if 8 <= seq < 256 and seq % 8 == 0:
        return "B1"
    return "B2" if seq <= 2048 else "B3"


def test_every_sequence_length_reaches_a_kernel_on_the_kernel_route(monkeypatch):
    """S = 1 to 2,100 on meta tensors: one launch of the expected entry point per forward
    (S = 1 is the v projection alone, no kernel), and never the plain path."""
    monkeypatch.setattr(_kernels, "attention_fwd", lambda *a: None)

    def no_plain(*a):
        raise AssertionError("plain_causal_attention ran on the kernel route")

    monkeypatch.setattr(tl, "plain_causal_attention", no_plain)
    counters = {"B1": tqkv.fused_qkv_causal_attention, "B2": tattn.fused_causal_attention,
                "B3": tattn.flash_causal_attention}
    attn = tl.Attention(16, 2, 8, torch.Generator().manual_seed(0)).to("meta").requires_grad_(False)
    seen = {key: 0 for key in counters}
    for seq in range(1, 2101):
        before = {key: fn.launches for key, fn in counters.items()}
        x = torch.empty(1, seq, 16, device="meta")
        out = attn(x, torch.zeros(1, seq, dtype=torch.bool, device="meta"))
        assert out.shape == (1, seq, 16)
        delta = {key: fn.launches - before[key] for key, fn in counters.items()}
        want = _expected(seq)
        assert delta == {key: int(key == want) for key in counters}, (seq, delta)
        if want:
            seen[want] += 1
    assert seen == {"B1": 31, "B2": 2048 - 1 - 31, "B3": 52}


def test_gates_keep_the_tpu_border_for_b1_and_take_every_s_for_b2():
    meta, cpu = torch.empty(0, device="meta"), torch.zeros(1)
    assert [s for s in range(1, 300) if tqkv.supports_qkv_fused(meta, s, 80)] == list(range(8, 256, 8))
    assert all(tattn.supports_fused(meta, s, 80) for s in (2, 3, 5, 7, 33, 1025, 1250, 2048))
    assert not tattn.supports_fused(meta, 2049, 80) and tattn.needs_flash(meta, 2049, 80)
    assert not any(f(cpu, 512, 80) for f in (tqkv.supports_qkv_fused, tattn.supports_fused, tattn.needs_flash))
    with tattn.kernel_route():
        assert tattn.supports_fused(cpu, 33, 80) and tqkv.supports_qkv_fused(cpu, 64, 80)
    assert not tattn.takes_kernels(cpu)


def test_a_head_dim_past_the_kernels_raises_on_the_kernel_route():
    attn = tl.Attention(600, 2, 300, torch.Generator().manual_seed(0)).to("meta").requires_grad_(False)
    with pytest.raises(ValueError, match="past the attention kernels"):
        attn(torch.empty(1, 33, 600, device="meta"), torch.zeros(1, 33, dtype=torch.bool, device="meta"))


@pytest.mark.parametrize("seq", [3, 33, 64, 1250])
def test_the_kernel_route_on_the_cpu_gives_the_plain_numbers(seq):
    """Inside kernel_route (used while exporting) a CPU tensor goes through the entry
    points, whose CPU implementation is the plain version: the same output."""
    attn = tl.Attention(16, 2, 8, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(seq)
    x = torch.from_numpy(rng.normal(size=(2, seq, 16)).astype(np.float32))
    pad = torch.zeros(2, seq, dtype=torch.bool)
    pad[1, : seq // 3] = True
    with torch.inference_mode():
        plain = attn(x, pad)
        with tattn.kernel_route():
            routed = attn(x, pad)
    valid = ~pad
    torch.testing.assert_close(routed[valid], plain[valid], rtol=0, atol=0)


def _f32_views(seq, heads=2, dim=80, offset=0, extra=0, dtype=torch.float32):
    """q, k, v as B1 reads them (views of one (B, S, 3 H D + extra) projection, the storage
    ``offset`` elements in) and an output, on meta tensors."""
    qkv = torch.empty(2 * seq * (3 * heads * dim + extra) + offset, dtype=dtype, device="meta")
    qkv = qkv[offset:].view(2, seq, 3 * heads * dim + extra)
    q, k, v = (t.unflatten(-1, (heads, dim)) for t in qkv[..., : 3 * heads * dim].chunk(3, dim=-1))
    return (q, k, v), torch.empty(2, seq, heads, dim, dtype=dtype, device="meta")


@pytest.mark.parametrize("backward", [False, True])
def test_fp32_head_dim_80_takes_route_5_from_its_border_and_route_4_below(backward):
    """fp32 at head_dim 80 on meta tensors: route 5 (3xTF32 wgmma fed by TMA) from the border the
    library's rule keeps (``TF32_WGMMA_FROM``, the constants of csrc/attention_*_tf32_hopper.cu),
    route 4 (3xTF32 mma.sync) below it, for B1's strided views of one projection and B2's
    contiguous tensors alike."""
    border = _kernels.TF32_WGMMA_FROM["backward" if backward else "forward"]
    for seq in (1, 16, 32, border - 1, border, border + 1, 512, 2100, 20000):
        (q, k, v), out = _f32_views(seq)
        ins = (q, k, v, out) if backward else (q, k, v)
        outs = (out, out, out) if backward else (out,)
        want = 5 if seq >= border else 4
        assert _kernels.causal_f32_route(backward, ins, outs) == want, seq
        split = tuple(torch.empty(2, seq, 2, 80, device="meta") for _ in range(3))
        assert _kernels.causal_f32_route(backward, split + ((out,) if backward else ()), outs) == want


@pytest.mark.parametrize("backward", [False, True])
def test_a_layout_tma_refuses_leaves_route_5(backward):
    """TMA reads an operand whose base and row stride are 16-byte aligned; route 4's 16-byte
    cp.async asks the same, so a layout TMA refuses leaves both 3xTF32 routes for the CUDA
    cores: a base 4 bytes in, a row stride of 3 H D + 2 floats. An output written 8 bytes a
    lane needs an 8-byte aligned base and an even row stride; another head_dim takes neither
    3xTF32 route."""
    seq = 512
    for offset, extra in ((1, 0), (0, 2), (2, 0)):
        (q, k, v), out = _f32_views(seq, offset=offset, extra=extra)
        ins = (q, k, v, out) if backward else (q, k, v)
        assert _kernels.causal_f32_route(backward, ins, (out,)) == 0, (offset, extra)
    (q, k, v), out = _f32_views(seq)
    odd = torch.empty(2 * seq * 2 * 80 + 1, device="meta")[1:].view(2, seq, 2, 80)
    assert _kernels.causal_f32_route(backward, (q, k, v), (odd,)) == 0
    (q, k, v), out = _f32_views(seq, dim=64)
    assert _kernels.causal_f32_route(backward, (q, k, v), (out,)) == 0


def test_bf16_borders_are_unchanged_and_the_fp32_overrides_leave_bf16_to_the_rule():
    """The bf16 routes keep their borders (persistent up to 64 tokens, wgmma from 65 forward and
    128 backward); the overrides "tf32 mma.sync" (4) and "tf32 wgmma" (5) act on fp32 only: the
    bf16 rules read the override as 1 or 2 alone, and the fp32 routes' rules read 3-5."""
    import re
    from pathlib import Path

    csrc = Path(_kernels.CSRC)

    def const(name, text):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    fwd_h = (csrc / "attention_fwd_hopper.cu").read_text()
    bwd_h = (csrc / "attention_bwd_hopper.cu").read_text()
    assert (const("kFwdFrom", fwd_h), const("kBwdFrom", bwd_h)) == (65, 128)
    assert const("kShortFwdTo", (csrc / "attention_fwd_short_hopper.cu").read_text()) == 64
    assert "if (force == 1 || D != kDim) return 0;\n  return force == 2 || S >= kFwdFrom;" in fwd_h
    assert "if (force == 1 || D != kDim) return 0;\n  return force == 2 || S >= kBwdFrom;" in bwd_h
    for name in ("attention_fwd_tf32_hopper.cu", "attention_bwd_tf32_hopper.cu"):
        assert "if (D != kD || force == 3 || force == 4) return 0;" in (csrc / name).read_text()
    assert _kernels.ROUTE_NAMES == {"rule": 0, "mma.sync": 1, "wgmma": 2, "cuda cores": 3, "tf32 mma.sync": 4,
                                    "tf32 wgmma": 5}
    (q, k, v), out = _f32_views(512, dtype=torch.bfloat16)
    assert q.dtype == torch.bfloat16 and tqkv.supports_qkv_fused(q, 64, 80)
