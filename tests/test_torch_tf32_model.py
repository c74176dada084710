"""The 3xTF32 arithmetic of the port's fp32 tensor-core routes, modelled in PyTorch on the CPU.

Shared by the tests of the Chronos route (``tests/test_torch_port_chronos_tf32.py``) and of the
causal route (``tests/test_torch_port_causal_tf32.py``), which import it; it holds no tests of its
own. The kernels' own pieces are ``csrc/tf32_common.cuh``'s.

- TF32: an fp32 value rounded to 10 mantissa bits, to nearest, ties away from zero (what
  ``cvt.rna.tf32.f32`` does; the kernels do it in two integer instructions); x splits into hi =
  tf32(x) and lo = tf32(x - hi).
- A product is taken per k-step of 8 as three ``mma.sync`` m16n8k8: lo hi, hi lo, hi hi, in that
  order, each summing its 8 exact products into the fp32 accumulator (one rounding).
- The causal route on ``wgmma`` (route 5, ``csrc/attention_tf32_hopper.cuh``) takes the same three
  products per k-step of 8 in the same order, but splits each operand by truncation: the tensor
  cores read an fp32 value stored as it is as hi = trunc(x) (its 13 low bits cleared), and lo =
  tf32(x - trunc(x)) (:func:`split_trunc`, :func:`wgmma3`).
"""

import re
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "multimodal_timesfm_torch" / "csrc"
COMMON = (CSRC / "tf32_common.cuh").read_text()


def const(name: str, text: str) -> int:
    """The value of ``constexpr int <name> = N;`` in a source's text."""
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` truncated to TF32 (its 13 low bits cleared): what the tensor cores read of an
    fp32 value stored as it is."""
    bits = x.contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def split_trunc(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Route 5's split: hi = trunc(x), lo = tf32(x - hi) (x - hi is exact in fp32)."""
    hi = tf32_trunc(x)
    return hi, tf32(x - hi)


def mma3(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, terms: int = 3, split_fn=split) -> torch.Tensor:
    """acc (..., M, N) fp32 plus a (..., M, K) b (..., K, N) as the routes take it: per k-step
    of 8, the mma of lo hi, of hi lo and of hi hi in that order (``terms=1``: hi hi only, one
    TF32 product), each adding its 8 products, exact, to the accumulator with one fp32
    rounding; each operand split by ``split_fn``."""
    pad = -a.shape[-1] % 8  # a k-step past the end multiplies zeros, as the kernels' padded tiles do
    a = torch.nn.functional.pad(a.float(), (0, pad))
    b = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    ah, al = split_fn(a)
    bh, bl = split_fn(b)
    pairs = ((al, bh), (ah, bl), (ah, bh)) if terms == 3 else ((ah, bh),)
    steps = a.shape[-1] // 8
    # Each k-step's 8 products summed exactly (in fp64), for every step at once; then added to
    # the accumulator step by step, mma by mma, each with one fp32 rounding.
    sums = [torch.einsum("...msj,...sjn->...smn", x.double().unflatten(-1, (steps, 8)),
                         y.double().unflatten(-2, (steps, 8))) for x, y in pairs]
    acc = acc.float()
    for k in range(steps):
        for part in sums:
            acc = (acc.double() + part[..., k, :, :]).float()
    return acc


def wgmma3(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """:func:`mma3` as route 5's wgmma products take it: the same three products a k-step of 8,
    in the same order, of operands split by :func:`split_trunc`."""
    return mma3(acc, a, b, terms, split_trunc)


def banks(ld: int) -> dict[str, list[int]]:
    """The shared-memory banks (4-byte words mod 32) one warp's fragment loads meet at row
    stride ``ld`` floats, by pattern: ldmatrix's eight 16-byte rows (load_a, load_bt2: the four
    banks of each row); the scalar loads of load_bp and load_at, (row 2t, column g) with
    lane = 4g + t ("8t+g"); and a scalar B fragment of X Y^T, (row g, column t) ("4g+t")."""
    out = {"ldmatrix": [(r * ld + c) % 32 for r in range(8) for c in range(4)]}
    out["8t+g"] = [(2 * (lane & 3) * ld + (lane >> 2)) % 32 for lane in range(32)]
    out["4g+t"] = [((lane >> 2) * ld + (lane & 3)) % 32 for lane in range(32)]
    return out
