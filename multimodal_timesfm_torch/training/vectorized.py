"""Vectorized hyperparameter sweeps: T trials trained at once over one shared backbone.

Counterpart of ``multimodal_timesfm_tpu/training/vectorized.py``. The frozen
module is shared by every trial; the trained child (``fusion`` in multimodal
mode, ``adapter`` in baseline mode) is a dict of stacked (T, ...) tensors, and
``torch.func.vmap`` runs the decoder over that trial axis through
``torch.func.functional_call``. The backbone's weights are read once per GEMM
for all trials, and every kernel folds the trial axis into its batch rows
(the custom ops' vmap rules, ``_DenseBf16.vmap``): one launch per layer for
T trials, where a sequential sweep makes T. The backward is plain autograd
of the summed per-trial losses outside the vmap; trials are independent, so
each trial's leaves get that trial's own gradient.

Per trial: learning rate, weight decay, warmup steps, the init and the epoch
order. Shared (structural): batch size, epochs, accumulation, the schedule
family, the fusion architecture; the sweep library groups sampled configs by
them (``time_mmd/sweep_lib.py``).

The optimizer is a functional AdamW whose lr, weight decay and warmup are
tensors, held step for step to the port's ``AdamW`` (the optax chain): the
per-trial clip trigger is a ``torch.where`` on the device, with no host
synchronisation. A T=1 run reproduces ``MultimodalTrainer``'s fused training
(the same permutation stream).

On CUDA without accumulation, one optimizer step of all trials (gather,
vmapped forward, backward, per-trial clip, AdamW) is one CUDA graph, captured
after one eager step (the step it stands for) and replayed, as
``MultimodalTrainer._step_runner`` does. The step programs and their graphs
sit in a bounded LRU of 8 and are reused by later calls of the same
structure; the eager step is the reference.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Any

import numpy as np
import torch
from torch.func import functional_call, vmap

from multimodal_timesfm_torch.training.trainer import (
    _refuse_unported,
    build_epoch_indices,
    quantile_objective,
)
from multimodal_timesfm_torch.utils.cache import lru_get

Trainable = dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# functional AdamW with tensor hyperparameters
# ---------------------------------------------------------------------------


def adamw_init(trainable: Trainable) -> dict:
    """Zero step count and moments for one trial's trained tensors."""
    device = next(iter(trainable.values())).device
    return {
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "mu": {k: torch.zeros_like(v) for k, v in trainable.items()},
        "nu": {k: torch.zeros_like(v) for k, v in trainable.items()},
    }


def schedule_scale(count: torch.Tensor, warmup: Any, total: int, kind: str) -> torch.Tensor:
    """The schedule's factor at step ``count`` with a tensor warmup (``optimization.make_schedule``'s
    shapes: linear warmup, then linear decay to 0 or a half cosine). Elementwise, so a (T,)
    count and warmup give T factors."""
    t = count.to(torch.float32)
    w = torch.as_tensor(warmup, dtype=torch.float32, device=t.device)
    warm = t / torch.clamp_min(w, 1.0)
    if kind == "linear":
        decay = torch.clamp_min((total - t) / torch.clamp_min(total - w, 1.0), 0.0)
    elif kind == "cosine":
        progress = (t - w) / torch.clamp_min(total - w, 1.0)
        decay = torch.clamp_min(0.5 * (1.0 + torch.cos(math.pi * progress)), 0.0)
    else:
        raise NotImplementedError(f"Unsupported lr_scheduler_type: {kind!r}")
    return torch.where(t < w, warm, decay)


def adamw_update(
    grads: Trainable,
    state: dict,
    params: Trainable,
    lr: Any,
    weight_decay: Any,
    *,
    max_grad_norm: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[Trainable, dict]:
    """One AdamW step of one trial: the port's ``AdamW`` (clip, Adam with torch-default
    betas and eps, decoupled weight decay, ``-lr``) with ``lr`` and ``weight_decay`` as
    tensors. Functional: returns (new params, new state). The global norm accumulates in
    fp32; whether it clips is chosen on the device."""
    if max_grad_norm > 0:
        g_norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
        trigger = g_norm < max_grad_norm
        grads = {
            k: torch.where(trigger, g, ((g.float() / g_norm) * max_grad_norm).to(g.dtype))
            for k, g in grads.items()
        }
    count = state["count"] + 1
    mu = {k: b1 * state["mu"][k] + (1.0 - b1) * g for k, g in grads.items()}
    nu = {k: b2 * state["nu"][k] + (1.0 - b2) * torch.square(g) for k, g in grads.items()}
    t = count.to(torch.float32)
    c1, c2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
    new_params = {
        k: p - lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps) + weight_decay * p)
        for k, p in params.items()
    }
    return new_params, {"count": count, "mu": mu, "nu": nu}


# ---------------------------------------------------------------------------
# the trial step: one optimizer step of T trials, eager or as a CUDA graph
# ---------------------------------------------------------------------------


class _Objective(torch.nn.Module):
    """One trial's objective over its batch, called through ``functional_call`` with that
    trial's trained tensors (``MultimodalTrainer._loss``'s objectives and its eval MSE)."""

    def __init__(self, decoder: torch.nn.Module, horizon_len: int, loss_type: str) -> None:
        super().__init__()
        if loss_type not in ("mse", "quantile"):
            raise ValueError(f"Unsupported loss_type: {loss_type!r} (expected 'mse' or 'quantile')")
        self.decoder = decoder
        self.horizon_len = horizon_len
        self.loss_type = loss_type

    def forward(
        self, context: torch.Tensor, horizon: torch.Tensor, text: torch.Tensor | None,
        weights: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """The weighted training loss; without ``weights``, the (B, H) fp32 errors of the
        point forecast (validation and test)."""
        masks = torch.zeros_like(context, dtype=torch.bool)
        if weights is None:
            return self.decoder(self.horizon_len, context, masks, text).float() - horizon
        denom = torch.clamp_min(torch.sum(weights) * self.horizon_len, 1.0)
        if self.loss_type == "mse":
            point = self.decoder(self.horizon_len, context, masks, text)
            err = (point.float() - horizon) ** 2
            return torch.sum(err * weights[:, None]) / denom
        full = self.decoder.forward_full(self.horizon_len, context, masks, text)
        return quantile_objective(
            full.float(), horizon, weights, denom, self.decoder.adapter.quantile_loss_spec
        )


class _TrialProgram:
    """The training of one structural group: its buffers, its step and the step's graph.

    Holds the T trials' trained tensors (leaves that require grad), their AdamW
    state and hyperparameters, the staged datasets, and the static index and
    weight buffers of a step, so a captured graph reads and writes the same
    tensors on every replay and in every later call of the same structure
    (``load`` copies a call's values in).
    """

    def __init__(
        self, model: torch.nn.Module, trainable_key: str, horizon_len: int, scheduler: str,
        total_steps: int, max_grad_norm: float, loss_type: str, inits: Trainable,
        data: dict[str, torch.Tensor], vdata: dict[str, torch.Tensor], batch: int,
    ) -> None:
        self.objective = _Objective(model, horizon_len, loss_type)
        self.prefix = f"decoder.{trainable_key}."
        self.scheduler, self.total_steps, self.max_grad_norm = scheduler, total_steps, max_grad_norm
        self.device = next(iter(inits.values())).device
        trials = next(iter(inits.values())).shape[0]
        self.params = {
            k: torch.empty(v.shape, dtype=torch.float32, device=self.device).requires_grad_()
            for k, v in inits.items()
        }
        self.opt = {
            "count": torch.zeros((trials,), dtype=torch.int32, device=self.device),
            "mu": {k: torch.zeros_like(v) for k, v in self.params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in self.params.items()},
        }
        self.hp = {k: torch.zeros((trials,), dtype=torch.float32, device=self.device)
                   for k in ("learning_rate", "weight_decay", "warmup_steps")}
        self.data = {k: torch.empty_like(v) for k, v in data.items()}
        self.vdata = {k: torch.empty_like(v) for k, v in vdata.items()}
        self.idx = torch.zeros((trials, batch), dtype=torch.int64, device=self.device)
        self.w = torch.zeros((trials, batch), dtype=torch.float32, device=self.device)
        self.graph: tuple[Any, torch.Tensor] | None = None
        self.graph_captures = 0
        self.graph_replays = 0

    @torch.no_grad()
    def load(self, inits: Trainable, hp: dict[str, torch.Tensor], data: dict, vdata: dict) -> None:
        for k, p in self.params.items():
            p.copy_(inits[k])
        self.opt["count"].zero_()
        for slots in (self.opt["mu"], self.opt["nu"]):
            for v in slots.values():
                v.zero_()
        for dst, src in ((self.hp, hp), (self.data, data), (self.vdata, vdata)):
            for k, v in dst.items():
                v.copy_(src[k])

    def _named(self, trainable: Trainable) -> Trainable:
        return {self.prefix + k: v for k, v in trainable.items()}

    def _trial_loss(self, trainable: Trainable, context, horizon, text, weights) -> torch.Tensor:
        return functional_call(self.objective, self._named(trainable), (context, horizon, text, weights))

    def micro(self, idx: torch.Tensor, weights: torch.Tensor) -> tuple[torch.Tensor, Trainable]:
        """(T,) losses of one micro-batch, rows ``idx`` (T, B) of each trial, and their
        gradients: the forward under ``vmap``, the backward outside it."""
        trials, batch = idx.shape
        flat = idx.reshape(-1)
        mb = {k: torch.index_select(v, 0, flat).unflatten(0, (trials, batch)) for k, v in self.data.items()}
        text = mb.get("text")
        losses = vmap(self._trial_loss, in_dims=(0, 0, 0, None if text is None else 0, 0))(
            self.params, mb["context"], mb["horizon"], text, weights
        )
        leaves = list(self.params.values())
        grads = torch.autograd.grad(losses.sum(), leaves, allow_unused=True, materialize_grads=True)
        return losses.detach(), dict(zip(self.params, grads))

    @torch.no_grad()
    def update(self, grads: Trainable) -> None:
        """The per-trial AdamW step (``adamw_update`` under ``vmap``), written in place."""
        lr = self.hp["learning_rate"] * schedule_scale(
            self.opt["count"], self.hp["warmup_steps"], self.total_steps, self.scheduler
        )

        def one(g, state, p, lr_t, wd_t):
            return adamw_update(g, state, p, lr_t, wd_t, max_grad_norm=self.max_grad_norm)

        params = {k: p.detach() for k, p in self.params.items()}
        new_params, new_state = vmap(one)(grads, self.opt, params, lr, self.hp["weight_decay"])
        torch._foreach_copy_(list(params.values()), list(new_params.values()))
        self.opt["count"].copy_(new_state["count"])
        for key in ("mu", "nu"):
            torch._foreach_copy_(list(self.opt[key].values()), list(new_state[key].values()))

    def step(self, micro_batches: list[tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
        """One optimizer step over ``accum`` micro-batches (the mean of their gradients, as
        JAX's scan sums them); returns their (T, accum) losses."""
        accum = len(micro_batches)
        losses, acc = [], None
        for idx, weights in micro_batches:
            loss, grads = self.micro(idx, weights)
            losses.append(loss)
            if accum == 1:
                acc = grads
            else:
                acc = {k: (torch.zeros_like(g) if acc is None else acc[k]) + g / accum for k, g in grads.items()}
        self.update(acc)
        return torch.stack(losses, dim=1)

    def run_step(self, perm: torch.Tensor, weights: torch.Tensor, e: int, s: int) -> torch.Tensor:
        """Step ``s`` of epoch ``e`` of (T, E, steps, accum, B) indices and weights.

        On CUDA without accumulation: one CUDA graph, captured once per program after
        one eager step on a side stream (the step it stands for), then replayed with the
        step's rows copied into the static buffers. Elsewhere the step runs eagerly.
        """
        accum = perm.shape[3]
        if self.device.type != "cuda" or accum != 1:
            return self.step([(perm[:, e, s, a], weights[:, e, s, a]) for a in range(accum)])
        self.idx.copy_(perm[:, e, s, 0])
        self.w.copy_(weights[:, e, s, 0])
        if self.graph is None:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                loss = self.step([(self.idx, self.w)])
            torch.cuda.current_stream(self.device).wait_stream(side)
            loss.record_stream(torch.cuda.current_stream(self.device))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self.step([(self.idx, self.w)])
            self.graph = (graph, out)
            self.graph_captures += 1
            return loss
        graph, out = self.graph
        graph.replay()
        self.graph_replays += 1
        return out.clone()

    @torch.no_grad()
    def val_losses(self, idx: torch.Tensor, weights: torch.Tensor, num_batches: int) -> torch.Tensor:
        """(T,) mean validation MSE over the first ``num_batches`` of (steps, B) rows, which
        the trials share (``MultimodalTrainer._val_loss`` per trial)."""
        params = {k: p.detach() for k, p in self.params.items()}
        mse = []
        for s in range(num_batches):
            err = _errors(self.objective, self.prefix, params, self.vdata, idx[s])
            denom = torch.clamp_min(torch.sum(weights[s]) * self.objective.horizon_len, 1.0)
            mse.append(torch.sum(err * err * weights[s][None, :, None], dim=(1, 2)) / denom)
        return torch.stack(mse, dim=1).mean(dim=1)


def _errors(
    objective: _Objective, prefix: str, trainable: Trainable, data: dict[str, torch.Tensor],
    idx: torch.Tensor,
) -> torch.Tensor:
    """(T, B, H) point errors of every trial on rows ``idx`` (B,) of ``data``, which the
    trials share: the decoder under ``vmap`` over the trial axis of ``trainable``."""
    ctx, hor = data["context"][idx], data["horizon"][idx]
    text = data["text"][idx] if "text" in data else None

    def one(tr: Trainable) -> torch.Tensor:
        return functional_call(objective, {prefix + k: v for k, v in tr.items()}, (ctx, hor, text))

    return vmap(one)(trainable)


# Trial programs (buffers, step, CUDA graph) keyed by (model, structure). Entries pin
# their decoder and buffers; the LRU bound keeps a sweep of many groups from growing
# device memory without end. Decoders are treated as immutable.
_PROGRAMS: OrderedDict[tuple, _TrialProgram] = OrderedDict()
_CACHE_MAX = 8


def release_programs(model: torch.nn.Module) -> None:
    """Drop the cached trial programs of ``model`` (their buffers, graphs and the
    reference to the model)."""
    for key in [k for k in _PROGRAMS if k[0] == id(model)]:
        del _PROGRAMS[key]


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _stage(data: dict, device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32)).to(device) for k, v in data.items()}


@dataclasses.dataclass
class TrialResults:
    """Per-trial outputs; arrays lead with the trial axis T."""

    train_losses: np.ndarray  # (T, E, num_micro_batches)
    val_losses: np.ndarray  # (T, E)
    best_val: np.ndarray  # (T,)
    best_epoch: np.ndarray  # (T,) int
    best_trainable: Trainable  # (T, ...) tensors on the model's device
    graph_captures: int = 0  # CUDA-graph captures and replays of the step in this call
    graph_replays: int = 0


def run_vectorized_trials(
    model: torch.nn.Module,
    trainable_inits: Trainable,
    train_data: dict,
    val_data: dict,
    hyperparams: dict,
    *,
    horizon_len: int,
    batch_size: int,
    num_epochs: int,
    accum: int = 1,
    scheduler: str = "linear",
    max_grad_norm: float = 1.0,
    trainable_key: str = "fusion",
    seed: int = 0,
    seed_stride: int = 1,
    eval_batch_size: int | None = None,
    mesh: Any = None,
    loss_type: str = "mse",
) -> TrialResults:
    """Train T trials at once over ``model``'s shared frozen child (JAX ``run_vectorized_trials``).

    Args:
        model: a ``MultimodalDecoder`` on its device, holding the frozen child (folded
            or cast as the caller wants it); its parameters are set not to require
            grad. Its ``trainable_key`` child is replaced per trial, never written.
        trainable_inits: the trained child's tensors by parameter name
            (``named_parameters`` of that child), each with a leading (T, ...) trial
            axis: ``stack_trainables`` or ``replicate_trainables``.
        train_data / val_data: "context", "horizon" (and "text") arrays, shared by
            the trials.
        hyperparams: (T,) arrays "learning_rate", "weight_decay", "warmup_steps"
            (already resolved to steps, float).
        scheduler: "linear" | "cosine" (structural).
        seed, seed_stride: trial t draws its epoch orders from
            ``default_rng(seed + t * seed_stride)`` as a ``MultimodalTrainer(seed=...)``
            does; ``seed_stride=0`` gives every trial the order a sequential sweep's trials get.
        mesh: not ported yet (ROADMAP queue A, item 10); raises.

    Returns:
        TrialResults, the best trainable per trial tracked on the device.
    """
    _refuse_unported(mesh=(mesh, mesh is not None, "10"))
    device = _device_of(model)
    model.requires_grad_(False)
    t_trials = int(np.shape(hyperparams["learning_rate"])[0])
    n_train = int(np.shape(train_data["context"])[0])
    n_val = int(np.shape(val_data["context"])[0])

    perms, weightss = [], []
    num_batches = 0
    for t in range(t_trials):
        rng = np.random.default_rng(seed + t * seed_stride)
        ep_p, ep_w = [], []
        for _ in range(num_epochs):
            p, w, num_batches = build_epoch_indices(n_train, batch_size, True, accum, 1, rng)
            ep_p.append(p)
            ep_w.append(w)
        perms.append(np.stack(ep_p))
        weightss.append(np.stack(ep_w))
    perm = torch.from_numpy(np.stack(perms).astype(np.int64)).to(device)  # (T, E, steps, accum, B)
    weights = torch.from_numpy(np.stack(weightss)).to(device)
    val_p, val_w, val_nb = build_epoch_indices(
        n_val, eval_batch_size or batch_size, False, 1, 1, np.random.default_rng(0)
    )
    val_idx = torch.from_numpy(val_p[:, 0].astype(np.int64)).to(device)
    val_weights = torch.from_numpy(val_w[:, 0]).to(device)
    total_steps = num_epochs * math.ceil(num_batches / accum)

    data, vdata = _stage(train_data, device), _stage(val_data, device)
    hp = {k: torch.as_tensor(np.asarray(v, np.float32)).to(device) for k, v in hyperparams.items()}
    inits = {k: torch.as_tensor(v).to(device, torch.float32) for k, v in trainable_inits.items()}
    key = (
        id(model), trainable_key, horizon_len, accum, scheduler, total_steps, max_grad_norm,
        loss_type, t_trials, perm.shape[-1], str(device),
        tuple((k, tuple(v.shape)) for k, v in sorted(inits.items())),
        tuple((k, tuple(v.shape)) for k, v in sorted(data.items())),
        tuple((k, tuple(v.shape)) for k, v in sorted(vdata.items())),
    )
    program = lru_get(
        _PROGRAMS,
        key,
        lambda: _TrialProgram(
            model, trainable_key, horizon_len, scheduler, total_steps, max_grad_norm, loss_type,
            inits, data, vdata, perm.shape[-1],
        ),
        _CACHE_MAX,
    )
    captures0, replays0 = program.graph_captures, program.graph_replays
    program.load(inits, hp, data, vdata)

    best_val = torch.full((t_trials,), np.finfo(np.float32).max, dtype=torch.float32, device=device)
    best = {k: p.detach().clone() for k, p in program.params.items()}
    num_steps = perm.shape[2]
    train_losses = torch.empty((t_trials, num_epochs, num_steps, accum), device=device)
    val_losses = torch.empty((t_trials, num_epochs), device=device)
    for e in range(num_epochs):
        for s in range(num_steps):
            train_losses[:, e, s] = program.run_step(perm, weights, e, s)
        val_loss = program.val_losses(val_idx, val_weights, val_nb)
        val_losses[:, e] = val_loss
        is_best = val_loss < best_val
        best_val = torch.where(is_best, val_loss, best_val)
        with torch.no_grad():
            for k, b in best.items():
                keep = is_best.reshape((t_trials,) + (1,) * (b.dim() - 1))
                b.copy_(torch.where(keep, program.params[k], b))

    loss_cube = train_losses.cpu().numpy()  # the run's one wait
    val_arr = val_losses.cpu().numpy()
    return TrialResults(
        train_losses=loss_cube.reshape(t_trials, num_epochs, -1)[:, :, :num_batches],
        val_losses=val_arr,
        best_val=best_val.cpu().numpy(),
        best_epoch=np.argmin(val_arr, axis=1),
        best_trainable=best,
        graph_captures=program.graph_captures - captures0,
        graph_replays=program.graph_replays - replays0,
    )


def stack_trainables(trainables: list[Trainable]) -> Trainable:
    """Stack per-trial trained tensors onto a leading trial axis (new tensors)."""
    return {k: torch.stack([torch.as_tensor(t[k]) for t in trainables]) for k in trainables[0]}


def replicate_trainables(trainable: Trainable, t_trials: int) -> Trainable:
    """``t_trials`` copies of ONE init on the trial axis, as read-only expanded views (the
    T-wide stack is never materialised: ``run_vectorized_trials`` copies it into its
    buffers). The sweep library's staging: every trial starts from the same init."""
    return {k: torch.as_tensor(v).detach().expand(t_trials, *np.shape(v)) for k, v in trainable.items()}


def device_hbm_bytes(default: int = 16 << 30) -> int:
    """The current CUDA device's memory (``torch.cuda.get_device_properties``); ``default``
    when there is no CUDA device."""
    if not torch.cuda.is_available():
        return default
    return int(torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory)


def vectorized_max_trials(
    trainable_bytes: int, hbm_bytes: int | None = None, headroom: float = 0.75
) -> int:
    """How many trials of a given trained-tree size fit on one device.

    Each trial carries its own fp32 copies of the trained tree: params, AdamW mu
    and nu, the tracked best, and the transient gradient, so
    ``per_trial = 5 * trainable_bytes``. The frozen child, the datasets and the
    activations are shared and budgeted by ``headroom``:

        T_max = floor(headroom * HBM / (5 * trainable_bytes))

    TimesFM-2.5 200M in baseline mode (0.81 GB of fp32 weights) on an 80 GB
    card gives T_max = floor(0.75 * 80 GB / 4.1 GB) = 14-15; the fusion MLP of
    a multimodal sweep (a few MB) fits thousands.
    """
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes()
    per_trial = 5 * trainable_bytes
    return max(int(headroom * hbm_bytes) // per_trial, 0)


def evaluate_vectorized(
    model: torch.nn.Module,
    trainables: Trainable,
    data: dict,
    *,
    horizon_len: int,
    batch_size: int,
    trainable_key: str = "fusion",
    mesh: Any = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Sample-weighted test MSE and MAE per trial (``MultimodalEvaluator``'s aggregation),
    the decoder under ``vmap`` over the trial axis of ``trainables``. Returns (T,) x 2.
    ``mesh`` is not ported yet (ROADMAP queue A, item 10) and raises."""
    _refuse_unported(mesh=(mesh, mesh is not None, "10"))
    device = _device_of(model)
    n = int(np.shape(data["context"])[0])
    perm, w, nb = build_epoch_indices(n, batch_size, False, 1, 1, np.random.default_rng(0))
    idx = torch.from_numpy(perm[:, 0].astype(np.int64)).to(device)
    weights = torch.from_numpy(w[:, 0]).to(device)
    staged = _stage(data, device)
    trials = {k: torch.as_tensor(v).to(device) for k, v in trainables.items()}
    objective = _Objective(model, horizon_len, "mse")
    prefix = f"decoder.{trainable_key}."
    se, ae, cnt = [], [], []
    with torch.no_grad():
        for s in range(nb):
            err = _errors(objective, prefix, trials, staged, idx[s])
            vw = weights[s][None, :, None]
            se.append(torch.sum(err * err * vw, dim=(1, 2)) / horizon_len)
            ae.append(torch.sum(torch.abs(err) * vw, dim=(1, 2)) / horizon_len)
            cnt.append(torch.sum(weights[s]))
        total = torch.clamp_min(torch.sum(torch.stack(cnt)), 1.0)
        mse = torch.stack(se, dim=1).sum(dim=1) / total
        mae = torch.stack(ae, dim=1).sum(dim=1) / total
    return mse.cpu().numpy(), mae.cpu().numpy()
