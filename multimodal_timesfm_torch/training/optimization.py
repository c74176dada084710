"""LR schedules and the AdamW optimizers.

Counterpart of ``multimodal_timesfm_tpu/training/optimization.py``. The
schedules are its HF-style lambdas in fp32 (linear warmup, then linear decay
to 0 or a half cosine), indexed by optimizer step; they take the step count
as a tensor and return the rate as a 0-d fp32 tensor on the count's device,
so an optimizer step reads no value back to the host and can be captured in
a CUDA graph.

Two optimizers share one state (a device step count, moments ``mu`` and
``nu`` stored in ``moment_dtype`` or each parameter's own dtype) and update
their parameters in place:

  * :class:`AdamW` is the JAX package's ``make_optimizer`` chain in optax's
    order: global-norm clipping with the norm accumulated in fp32, Adam with
    torch-default betas and eps, decoupled weight decay, then the step of
    ``-lr``. Every update accumulates in fp32 and rounds once on store, which
    is ``optax.adamw`` for fp32 moments and the JAX package's
    ``scale_by_adam_lowmem`` for bf16 ones;
  * :class:`FusedOptimizer` (``make_fused_adamw``) is JAX's fused stepper:
    the same math with the branchless clip ``max_norm / max(norm, max_norm)``
    and the clipped gradient kept in fp32, over all trained tensors at once
    with ``torch._foreach_*``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from multimodal_timesfm_torch.parallel.collectives import ModelAxis, reduce_from_model

Schedule = Callable[[torch.Tensor], torch.Tensor]


def linear_schedule_with_warmup(
    base_lr: float, num_warmup_steps: int, num_training_steps: int
) -> Schedule:
    """lr(t) = base * t/warmup for t < warmup, else base * (T-t)/(T-warmup), floored at 0."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(count).to(torch.float32)
        warm = t / max(1, num_warmup_steps)
        decay = torch.clamp_min(
            (num_training_steps - t) / max(1, num_training_steps - num_warmup_steps), 0.0
        )
        return base_lr * torch.where(t < num_warmup_steps, warm, decay)

    return schedule


def cosine_schedule_with_warmup(
    base_lr: float,
    num_warmup_steps: int,
    num_training_steps: int,
    num_cycles: float = 0.5,
) -> Schedule:
    """Linear warmup then cosine decay: base * 0.5*(1+cos(pi * cycles * 2 * progress))."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(count).to(torch.float32)
        warm = t / max(1, num_warmup_steps)
        progress = (t - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        decay = torch.clamp_min(0.5 * (1.0 + torch.cos(math.pi * num_cycles * 2.0 * progress)), 0.0)
        return base_lr * torch.where(t < num_warmup_steps, warm, decay)

    return schedule


def make_schedule(
    lr_scheduler_type: str, base_lr: float, num_warmup_steps: int, num_training_steps: int
) -> Schedule:
    if lr_scheduler_type == "linear":
        return linear_schedule_with_warmup(base_lr, num_warmup_steps, num_training_steps)
    if lr_scheduler_type == "cosine":
        return cosine_schedule_with_warmup(base_lr, num_warmup_steps, num_training_steps)
    raise NotImplementedError(f"Unsupported lr_scheduler_type: {lr_scheduler_type!r}")


def _global_norm_fp32(grads: Sequence[torch.Tensor], model_axis: ModelAxis | None = None,
                      sharded: Sequence[bool] = ()) -> torch.Tensor:
    """sqrt of the sum, in tensor order, of each tensor's fp32 sum of squares.

    With ``model_axis``, the tensors flagged in ``sharded`` are this rank's
    blocks: their squares are summed over the axis, the replicated ones
    counted once, which is the norm of the whole (logical) tensors.
    """
    squares = [torch.sum(torch.square(g.float())) for g in grads]
    if model_axis is None:
        return torch.sqrt(sum(squares))
    whole = sum(s for s, flag in zip(squares, sharded) if flag)
    whole = reduce_from_model(torch.as_tensor(whole, dtype=torch.float32, device=squares[0].device), model_axis)
    return torch.sqrt(sum((s for s, flag in zip(squares, sharded) if not flag), whole))


def clip_by_global_norm_fp32(grads: Sequence[torch.Tensor], max_norm: float,
                             model_axis: ModelAxis | None = None,
                             sharded: Sequence[bool] = ()) -> list[torch.Tensor]:
    """Scale ``grads`` by ``max_norm / norm`` when their global norm reaches ``max_norm``.

    The norm accumulates each tensor's sum of squares in fp32 whatever the
    gradients' dtype; below ``max_norm`` the gradients pass unchanged. The
    choice is made on the device (no host synchronisation). ``model_axis``
    and ``sharded``: see :func:`_global_norm_fp32`.
    """
    norm = _global_norm_fp32(grads, model_axis, sharded)
    keep = norm < max_norm
    return [torch.where(keep, g, ((g.float() / norm) * max_norm).to(g.dtype)) for g in grads]


class _Adam:
    """State shared by both optimizers: parameters, schedule, step count and moments.

    ``count`` is the number of steps taken, kept on the parameters' device;
    the learning rate of a step is ``schedule(count)`` before it is
    incremented, as optax's ``scale_by_learning_rate`` reads it.
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
        model_axis: ModelAxis | None = None,
        sharded: Sequence[bool] = (),
    ) -> None:
        self.params = list(params)
        # Tensor parallelism: which params are this rank's blocks, for the clip's norm.
        self.model_axis, self.sharded = model_axis, tuple(sharded)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self._count = torch.zeros((), dtype=torch.int32, device=self.params[0].device)
        self.mu = [torch.zeros_like(p, dtype=moment_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=moment_dtype or p.dtype) for p in self.params]

    @property
    def count(self) -> int:
        """Steps taken (reads the device counter back)."""
        return int(self._count)

    @count.setter
    def count(self, value: int) -> None:
        self._count.fill_(value)

    def _advance(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(lr, c1, c2) of this step, as 0-d fp32 device tensors; increments the count."""
        lr = self.schedule(self._count)
        self._count += 1
        t = self._count.float()
        return lr, 1.0 - torch.pow(self.b1, t), 1.0 - torch.pow(self.b2, t)

    def _check(self, grads: Sequence[torch.Tensor]) -> None:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")


class AdamW(_Adam):
    """Clip -> Adam -> decoupled weight decay -> ``-lr``, applied in place to ``params``."""

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from ``grads`` (one per parameter, in order)."""
        self._check(grads)
        if self.max_grad_norm > 0:
            grads = clip_by_global_norm_fp32(grads, self.max_grad_norm, self.model_axis, self.sharded)
        lr, c1, c2 = self._advance()
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g32 = g.float()
            m32 = m.float() * self.b1 + g32 * (1.0 - self.b1)
            v32 = v.float() * self.b2 + torch.square(g32) * (1.0 - self.b2)
            update = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
            update = update + self.weight_decay * p.float()
            p.add_((update * -lr).to(p.dtype))
            m.copy_(m32)
            v.copy_(v32)


class FusedOptimizer(_Adam):
    """AdamW as one fused step over every trained tensor (JAX ``FusedOptimizer``).

    The same math as :class:`AdamW` except, when clipping triggers, the
    branchless ``max_norm / max(norm, max_norm)`` multiply and the clipped
    gradient kept in fp32 for the moments (the chain divides, multiplies and
    rounds it back to the gradient's dtype). Each stage is one
    ``torch._foreach_*`` call over all tensors, in JAX's order of operations.
    """

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from ``grads`` (one per parameter, in order)."""
        self._check(grads)
        lr, c1, c2 = self._advance()
        g32 = [g.float() for g in grads]
        if self.max_grad_norm > 0:
            norm = _global_norm_fp32(g32, self.model_axis, self.sharded)
            clip = self.max_grad_norm / torch.clamp_min(norm, self.max_grad_norm)
            g32 = torch._foreach_mul(g32, clip)
        m32 = torch._foreach_add(
            torch._foreach_mul([m.float() for m in self.mu], self.b1),
            torch._foreach_mul(g32, 1.0 - self.b1),
        )
        v32 = torch._foreach_add(
            torch._foreach_mul([v.float() for v in self.nu], self.b2),
            torch._foreach_mul(torch._foreach_mul(g32, g32), 1.0 - self.b2),
        )
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v32, c2)), self.eps)
        update = torch._foreach_div(torch._foreach_div(m32, c1), denom)
        p32 = [p.float() for p in self.params]
        torch._foreach_add_(update, torch._foreach_mul(p32, self.weight_decay))
        new_p = torch._foreach_sub(p32, torch._foreach_mul(update, lr))
        torch._foreach_copy_(self.params, new_p)
        torch._foreach_copy_(self.mu, m32)
        torch._foreach_copy_(self.nu, v32)


def make_fused_adamw(
    params: Sequence[torch.Tensor],
    schedule: Schedule,
    weight_decay: float,
    max_grad_norm: float,
    moment_dtype: torch.dtype | None = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> FusedOptimizer:
    """The fused AdamW stepper over ``params`` (JAX ``make_fused_adamw``)."""
    return FusedOptimizer(params, schedule, weight_decay, max_grad_norm, moment_dtype, b1, b2, eps)
