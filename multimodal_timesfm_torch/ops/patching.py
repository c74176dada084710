"""Patching helpers: reshape raw series into fixed-size patches."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def patchify(x: torch.Tensor, patch_len: int) -> torch.Tensor:
    """(B, C) -> (B, C // patch_len, patch_len). C must be a multiple of patch_len."""
    batch, context = x.shape
    if context % patch_len != 0:
        raise ValueError(f"context length ({context}) must be divisible by patch length ({patch_len})")
    return x.reshape(batch, context // patch_len, patch_len)


def unpatchify(x: torch.Tensor) -> torch.Tensor:
    """(B, N, P) -> (B, N * P)."""
    return x.reshape(x.shape[0], -1)


def pad_and_patchify(x: torch.Tensor, patch_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Left-pad a (B, C) series to a patch multiple, returning (patches, pad_mask).

    The pad mask is True at padded positions. Padding goes on the left so the
    most recent data sits at the end of the last patch.
    """
    batch, context = x.shape
    rem = (-context) % patch_len
    mask = torch.zeros((batch, context + rem), dtype=torch.bool, device=x.device)
    if rem:
        x = F.pad(x, (rem, 0))
        mask[:, :rem] = True
    return patchify(x, patch_len), patchify(mask, patch_len)
