"""Reversible instance normalization (RevIN) with masked running statistics.

For each input patch ``i`` the stats are the mean and std of all valid
(unmasked) points in patches ``0..i``, a causal running estimate, computed in
closed form from cumulative masked moments (counterpart of
``multimodal_timesfm_tpu/ops/revin.py``). Mask convention: True = padded.
"""

from __future__ import annotations

import torch

_STD_EPS = 1e-6


def masked_running_stats(
    patched_inputs: torch.Tensor, patched_masks: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-patch-prefix masked mean and population std.

    ``E[x^2] - E[x]^2`` cancels catastrophically in fp32 once ``|mean| >>
    std`` (an offset of 1e4 collapses sigma to 0), so each series is first
    shifted by its first valid value: the variance is shift-invariant and the
    shifted values stay O(data range).

    Args:
        patched_inputs: (B, N, P) float values.
        patched_masks: (B, N, P) bool, True = padded.

    Returns:
        (mu, sigma), each (B, N); 0 where no valid point has been seen yet.
    """
    batch, num_patches, patch = patched_inputs.shape
    flat_x = patched_inputs.reshape(batch, -1)
    flat_valid = (~patched_masks).reshape(batch, -1)

    # Shift by the first valid value of each series (0 if none are valid).
    first_idx = flat_valid.to(torch.uint8).argmax(dim=-1)
    any_valid = flat_valid.any(dim=-1)
    first = flat_x.gather(1, first_idx[:, None])[:, 0]
    shift = torch.where(any_valid, first, torch.zeros_like(first))

    valid = flat_valid.reshape(batch, num_patches, patch).to(patched_inputs.dtype)
    x = (patched_inputs - shift[:, None, None]) * valid

    n = valid.sum(dim=-1).cumsum(dim=-1)  # (B, N)
    s1 = x.sum(dim=-1).cumsum(dim=-1)
    s2 = (x * x).sum(dim=-1).cumsum(dim=-1)

    safe_n = n.clamp_min(1.0)
    mu_shifted = s1 / safe_n
    var = (s2 / safe_n - mu_shifted * mu_shifted).clamp_min(0.0)
    sigma = var.sqrt()
    mu = mu_shifted + shift[:, None]
    seen = n > 0
    zero = torch.zeros_like(mu)
    return torch.where(seen, mu, zero), torch.where(seen, sigma, zero)


def revin(
    x: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """(Un-)normalize ``x`` with per-(batch, patch) stats broadcast over trailing dims.

    ``sigma`` below 1e-6 is treated as 1.

    Args:
        x: (B, N, ...) values.
        mu, sigma: (B, N) running stats.
        reverse: False -> normalize, True -> denormalize.
    """
    extra = x.dim() - mu.dim()
    mu = mu.reshape(mu.shape + (1,) * extra)
    sigma = sigma.reshape(sigma.shape + (1,) * extra)
    safe_sigma = torch.where(sigma < _STD_EPS, torch.ones_like(sigma), sigma)
    if reverse:
        return x * safe_sigma + mu
    return (x - mu) / safe_sigma
