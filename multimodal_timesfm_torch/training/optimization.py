"""LR schedules and the AdamW optimizer.

Counterpart of ``multimodal_timesfm_tpu/training/optimization.py``. The
schedules are its HF-style lambdas in fp32 (linear warmup, then linear decay
to 0 or a half cosine), indexed by optimizer step. The optimizer is its
``make_optimizer`` chain in optax's order: global-norm clipping with the norm
accumulated in fp32, Adam with torch-default betas and eps, decoupled weight
decay, then the step of ``-lr``. One functional AdamW over a list of tensors
covers both moment dtypes: the moments are stored in ``moment_dtype`` (each
parameter's own dtype when None) and every update accumulates in fp32 and
rounds once on store, which is ``optax.adamw`` for fp32 moments and the JAX
package's ``scale_by_adam_lowmem`` for bf16 ones.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]


def linear_schedule_with_warmup(
    base_lr: float, num_warmup_steps: int, num_training_steps: int
) -> Schedule:
    """lr(t) = base * t/warmup for t < warmup, else base * (T-t)/(T-warmup), floored at 0."""

    def schedule(count: int) -> float:
        t = np.float32(count)
        if t < num_warmup_steps:
            factor = t / np.float32(max(1, num_warmup_steps))
        else:
            factor = max(
                np.float32(0.0),
                (np.float32(num_training_steps) - t)
                / np.float32(max(1, num_training_steps - num_warmup_steps)),
            )
        return float(np.float32(base_lr) * factor)

    return schedule


def cosine_schedule_with_warmup(
    base_lr: float,
    num_warmup_steps: int,
    num_training_steps: int,
    num_cycles: float = 0.5,
) -> Schedule:
    """Linear warmup then cosine decay: base * 0.5*(1+cos(pi * cycles * 2 * progress))."""

    def schedule(count: int) -> float:
        t = np.float32(count)
        if t < num_warmup_steps:
            factor = t / np.float32(max(1, num_warmup_steps))
        else:
            progress = (t - np.float32(num_warmup_steps)) / np.float32(
                max(1, num_training_steps - num_warmup_steps)
            )
            cos = np.cos(np.float32(math.pi * num_cycles * 2.0) * progress)
            factor = max(np.float32(0.0), np.float32(0.5) * (np.float32(1.0) + cos))
        return float(np.float32(base_lr) * factor)

    return schedule


def make_schedule(
    lr_scheduler_type: str, base_lr: float, num_warmup_steps: int, num_training_steps: int
) -> Schedule:
    if lr_scheduler_type == "linear":
        return linear_schedule_with_warmup(base_lr, num_warmup_steps, num_training_steps)
    if lr_scheduler_type == "cosine":
        return cosine_schedule_with_warmup(base_lr, num_warmup_steps, num_training_steps)
    raise NotImplementedError(f"Unsupported lr_scheduler_type: {lr_scheduler_type!r}")


def clip_by_global_norm_fp32(grads: Sequence[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """Scale ``grads`` by ``max_norm / norm`` when their global norm reaches ``max_norm``.

    The norm accumulates each tensor's sum of squares in fp32 whatever the
    gradients' dtype; below ``max_norm`` the gradients pass unchanged. The
    choice is made on the device (no host synchronisation).
    """
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, ((g.float() / norm) * max_norm).to(g.dtype)) for g in grads]


class AdamW:
    """Clip -> Adam -> decoupled weight decay -> ``-lr``, applied in place to ``params``.

    ``count`` is the number of steps taken; the learning rate of a step is
    ``schedule(count)`` before it is incremented, as optax's
    ``scale_by_learning_rate`` reads it. ``mu`` and ``nu`` hold the moments
    in ``moment_dtype``.
    """

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        schedule: Schedule,
        weight_decay: float,
        max_grad_norm: float,
        moment_dtype: torch.dtype | None = None,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ) -> None:
        self.params = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=moment_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=moment_dtype or p.dtype) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from ``grads`` (one per parameter, in order)."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if self.max_grad_norm > 0:
            grads = clip_by_global_norm_fp32(grads, self.max_grad_norm)
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        c1 = float(np.float32(1.0) - b1 ** np.float32(self.count))
        c2 = float(np.float32(1.0) - b2 ** np.float32(self.count))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g32 = g.float()
            m32 = m.float() * self.b1 + g32 * (1.0 - self.b1)
            v32 = v.float() * self.b2 + torch.square(g32) * (1.0 - self.b2)
            update = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
            update = update + self.weight_decay * p.float()
            p.add_((update * -lr).to(p.dtype))
            m.copy_(m32)
            v.copy_(v32)
