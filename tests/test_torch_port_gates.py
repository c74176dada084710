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
