"""PyTorch port vs the JAX package: gradients, optimizer, trainer, checkpoints, evaluator.

Both packages get the same parameters (a numpy tree drawn from a seed and
loaded into the port through ``models/bridge.py``) and the same numpy inputs;
the port runs on the CPU through its plain attention path, as JAX does off
the TPU. Tolerances are stated beside each test.
"""

import dataclasses
import logging
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from multimodal_timesfm_tpu.models import layers as jl
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoder as JDecoder
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoderConfig as JDecoderConfig
from multimodal_timesfm_tpu.models.timesfm import TimesFM2p5Adapter as JAdapter
from multimodal_timesfm_tpu.models.timesfm import TimesFMConfig as JConfig
from multimodal_timesfm_tpu.training import optimization as jopt
from multimodal_timesfm_tpu.training.evaluator import MultimodalEvaluator as JEvaluator
from multimodal_timesfm_tpu.training.trainer import MultimodalTrainer as JTrainer
from multimodal_timesfm_tpu.training.trainer import build_epoch_indices as j_build_epoch_indices
from multimodal_timesfm_tpu.training.trainer import quantile_objective as j_quantile_objective
from multimodal_timesfm_tpu.training_args import TrainingArguments as JArgs
from multimodal_timesfm_torch.models import layers as tl
from multimodal_timesfm_torch.models.bridge import export_jax_params, load_jax_params, random_jax_params
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
from multimodal_timesfm_torch.training import optimization as topt
from multimodal_timesfm_torch.training.checkpoint import load_checkpoint
from multimodal_timesfm_torch.training.evaluator import MultimodalEvaluator
from multimodal_timesfm_torch.training.trainer import (
    MultimodalTrainer,
    build_epoch_indices,
    quantile_objective,
)
from multimodal_timesfm_torch.training_args import TrainingArguments
from multimodal_timesfm_torch.utils.logging import get_logger, setup_logger
from multimodal_timesfm_torch.utils.seed import set_seed

TEXT = 6
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(jnp.asarray(tree, jnp.float32))}
    out = {}
    for key, value in items:
        out.update(_leaves(value, f"{prefix}/{key}"))
    return out


def _assert_trees_close(port_tree, jax_tree, rel):
    """fp32 (``rel`` < 1e-3): every element within ``rel`` x the largest magnitude over all
    reference leaves. bf16: every leaf within ``rel`` of its reference in norm, since a
    ReLU whose bf16 input rounds to the other side of 0 moves a few elements by a step."""
    port, ref = _leaves(port_tree), _leaves(jax_tree)
    assert port.keys() == ref.keys()
    scale = max(np.abs(v).max() for v in ref.values())
    for key in ref:
        if rel < 1e-3:
            np.testing.assert_allclose(port[key], ref[key], rtol=0, atol=rel * scale, err_msg=key)
        else:
            err = np.linalg.norm(port[key] - ref[key])
            assert err <= rel * np.linalg.norm(ref[key]) + 1e-12, (key, err / np.linalg.norm(ref[key]))


# ---------------------------------------------------------------------------
# swish, and gradients of the layers and of the decoder
# ---------------------------------------------------------------------------


def test_bf16_swish_is_bit_equal_to_jax():
    """Every bf16 value in [-16, 16): forward and gradient bit-equal to jax.nn.swish."""
    grid = np.arange(-16 * 256, 16 * 256, dtype=np.float32) / 256
    cot = (grid / 7).astype(np.float32)
    jx = jnp.asarray(grid, jnp.bfloat16)
    ref, vjp = jax.vjp(jax.nn.swish, jx)
    (ref_grad,) = vjp(jnp.asarray(cot, jnp.bfloat16))
    x = torch.from_numpy(grid).to(torch.bfloat16).requires_grad_()
    out = tl.swish(x)
    out.backward(torch.from_numpy(cot).to(torch.bfloat16))
    np.testing.assert_array_equal(out.float().detach().numpy(), np.asarray(ref, np.float32))
    np.testing.assert_array_equal(x.grad.float().numpy(), np.asarray(ref_grad, np.float32))
    # fp32: one rounding apart at most; a finite gradient where exp(-x) overflows.
    t = torch.from_numpy(grid)
    np.testing.assert_allclose(tl.swish(t).numpy(), np.asarray(jax.nn.swish(jnp.asarray(grid))), atol=5e-7)
    far = torch.tensor([-100.0, 100.0], requires_grad=True)
    tl.swish(far).sum().backward()
    np.testing.assert_array_equal(far.grad.numpy(), [0.0, 1.0])


class _Stack(nn.Module):
    """Gives a bare stack the ``stacked_xf`` name, so the bridge stacks its leaves."""

    def __init__(self, stack):
        super().__init__()
        self.stacked_xf = stack


def _layer_case(kind, seq, dtype):
    """(port module, its JAX params, JAX apply fn, x, paddings, cotangent) at tiny widths."""
    gen = torch.Generator().manual_seed(0)
    heads, dim, md = 2, 16, 32
    if kind == "attention":
        module = tl.Attention(md, heads, dim, gen)
        apply = lambda p, x, pad: jl.causal_attention(p, x, pad, heads, dim)  # noqa: E731
    elif kind == "layer":
        module = tl.TransformerLayer(md, heads, dim, 48, gen)
        apply = lambda p, x, pad: jl.transformer_layer(p, x, pad, heads, dim)  # noqa: E731
    else:
        module = _Stack(tl.StackedTransformer(2, md, heads, dim, 48, gen))
        apply = lambda p, x, pad: jl.stacked_transformer(p["stacked_xf"], x, pad, heads, dim)  # noqa: E731
    tree = random_jax_params(module, seq)
    load_jax_params(module, tree)
    rng = np.random.default_rng(seq)
    x = rng.normal(size=(3, seq, md)).astype(np.float32)
    pad = np.zeros((3, seq), bool)
    pad[1, : seq // 3] = True  # left padding
    cot = rng.normal(size=(3, seq, md)).astype(np.float32)
    return module, tree, apply, x, pad, cot


# fp32: every element within 1e-5 of the largest reference gradient (summation
# order; measured <= 9.3e-7). bf16: every leaf within 0.1 in norm (activations
# round at the same places in both packages, a few ulps apart, and a ReLU input
# near 0 may round to the other side; measured <= 0.061).
LAYER_TOL = {"float32": 1e-5, "bfloat16": 0.1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [1, 16, 64])
@pytest.mark.parametrize("kind", ["attention", "layer", "stack"])
def test_layer_gradients_match_jax(kind, tokens, dtype):
    """Gradients of every parameter (per_dim_scale included: the query scale is applied
    out of place) and of the input, against jax.grad."""
    module, tree, apply, x, pad, cot = _layer_case(kind, tokens, dtype)

    def j_loss(params, xj):
        out = apply(params, xj, jnp.asarray(pad))
        return jnp.sum(out.astype(jnp.float32) * cot)

    j_params, j_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x, JDT[dtype])
    )
    tx = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    forward = module.stacked_xf if kind == "stack" else module
    out = forward(tx, torch.from_numpy(pad))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    # At one token the q and k projections and the query scale are unused (softmax over
    # one key): no .grad, where jax.grad gives zeros.
    grads = export_jax_params(
        module, {p: torch.zeros_like(p) if p.grad is None else p.grad for p in module.parameters()}
    )
    _assert_trees_close(grads, j_params, LAYER_TOL[dtype])
    _assert_trees_close({"x": tx.grad.float()}, {"x": j_x}, LAYER_TOL[dtype])


def _decoder_pair(dtype="float32", seed=0, config=None):
    cfg = dataclasses.replace(TimesFMConfig.tiny(), compute_dtype=TDT[dtype], **(config or {}))
    port = MultimodalDecoder(
        TimesFM2p5Adapter(cfg), MultimodalDecoderConfig(text_embedding_dims=TEXT), device="cpu"
    )
    tree = random_jax_params(port, seed)
    load_jax_params(port, tree)
    jcfg = dataclasses.replace(JConfig.tiny(), compute_dtype=JDT[dtype], **(config or {}))
    jdec = JDecoder(JAdapter(jcfg), JDecoderConfig(text_embedding_dims=TEXT))
    return port, jdec, tree


# As LAYER_TOL (measured fp32 <= 9.3e-7, bf16 <= 0.061 in norm).
DECODER_TOL = LAYER_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [1, 16, 64])
@pytest.mark.parametrize("mode", ["multimodal", "baseline"])
def test_decoder_gradients_match_jax(mode, tokens, dtype):
    """The trainer's weighted MSE (one zero-weight row) differentiated w.r.t. the trained
    subtree: the fusion MLP with text (multimodal) or the whole adapter (baseline)."""
    port, jdec, tree = _decoder_pair(dtype, seed=tokens)
    key = "fusion" if mode == "multimodal" else "adapter"
    rng = np.random.default_rng(tokens + 1)
    context = tokens * 4
    x = (rng.normal(size=(3, context)) * 5 + 100).astype(np.float32)
    horizon = (rng.normal(size=(3, 8)) * 5 + 100).astype(np.float32)
    text = rng.normal(size=(3, tokens, TEXT)).astype(np.float32) if mode == "multimodal" else None
    weights = np.array([1.0, 1.0, 0.0], np.float32)

    def j_loss(sub):
        params = dict(jax.tree.map(jnp.asarray, tree))
        params[key] = sub
        point = jdec(params, 8, jnp.asarray(x), jnp.zeros(x.shape, bool),
                     None if text is None else jnp.asarray(text))
        err = (point.astype(jnp.float32) - horizon) ** 2
        return jnp.sum(err * weights[:, None]) / (weights.sum() * 8)

    ref = jax.jit(jax.grad(j_loss))(jax.tree.map(jnp.asarray, tree[key]))
    sub = getattr(port, key)
    port.requires_grad_(False)
    sub.requires_grad_(True)
    point = port(8, torch.from_numpy(x), torch.zeros(x.shape, dtype=torch.bool),
                 None if text is None else torch.from_numpy(text))
    err = (point.float() - torch.from_numpy(horizon)) ** 2
    loss = (err * torch.from_numpy(weights)[:, None]).sum() / (weights.sum() * 8)
    grads = torch.autograd.grad(loss, list(sub.parameters()), allow_unused=True, materialize_grads=True)
    _assert_trees_close(export_jax_params(sub, dict(zip(sub.parameters(), grads))), ref, DECODER_TOL[dtype])


# ---------------------------------------------------------------------------
# schedules, clipping and AdamW against the optax chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_schedules_match_jax(kind):
    ours = topt.make_schedule(kind, 3e-4, 4, 17)
    ref = jopt.make_schedule(kind, 3e-4, 4, 17)
    np.testing.assert_allclose(
        [ours(t) for t in range(20)], [float(ref(t)) for t in range(20)], rtol=1e-6, atol=1e-12
    )


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax_chain(moment_dtype):
    """Six steps of clip (it triggers on the large steps) -> AdamW -> apply, against the
    JAX package's make_optimizer; parameters and moments after every step. fp32: the
    same fp32 ops (bias corrections via pow may round apart); bf16 moments: the same
    fp32 accumulation rounded once on store."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    schedule = jopt.make_schedule("cosine", 1e-2, 2, 6)
    jdt = jnp.bfloat16 if moment_dtype == "bfloat16" else None
    chain = jopt.make_optimizer(schedule, 0.01, 1.0, moment_dtype=jdt)
    jparams = [jnp.asarray(p) for p in params]
    jstate = chain.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    opt = topt.AdamW(tparams, topt.make_schedule("cosine", 1e-2, 2, 6), 0.01, 1.0,
                     torch.bfloat16 if jdt is not None else None)
    for step in range(6):
        grads = [(rng.normal(size=s) * (3.0 if step % 2 else 0.1)).astype(np.float32) for s in shapes]
        updates, jstate = chain.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(g) for g in grads])
        for ours, ref in zip(tparams, jparams):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    adam = jstate[-1][0] if jdt is None else jstate[-3]
    assert opt.count == int(adam.count) == 6
    for ours, ref in zip(opt.mu + opt.nu, list(adam.mu) + list(adam.nu)):
        assert ours.dtype == (torch.bfloat16 if jdt is not None else torch.float32)
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32), rtol=1e-5, atol=1e-9)


def test_clip_by_global_norm_fp32_matches_jax():
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (7,))]
    for max_norm in (0.5, 100.0):  # triggers, then passes through
        ref, _ = jopt.clip_by_global_norm_fp32(max_norm).update([jnp.asarray(g) for g in grads], None)
        ours = topt.clip_by_global_norm_fp32([torch.from_numpy(g) for g in grads], max_norm)
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the trainer against JAX's
# ---------------------------------------------------------------------------


def _samples(n, seed, context=16):
    rng = np.random.default_rng(seed)
    return [
        {
            "context": (rng.normal(size=context) + np.sin(np.arange(context))).astype(np.float32),
            "horizon": rng.normal(size=8).astype(np.float32),
            "text_embeddings": rng.normal(size=(context // 4, TEXT)).astype(np.float32),
            "metadata": {},
        }
        for _ in range(n)
    ]


def _train_kwargs(**over):
    kw = dict(
        per_device_train_batch_size=8, per_device_eval_batch_size=4, num_train_epochs=3,
        learning_rate=1e-3, lr_scheduler_type="linear", warmup_steps=1, weight_decay=0.01,
        max_grad_norm=1.0, eval_strategy="epoch", save_strategy="no", logging_strategy="no", seed=7,
    )
    kw.update(over)
    return kw


# The ceiling of tests/test_trajectory_parity.py: losses rtol 2e-3, final
# parameters atol 5e-4 (fp32 noise carried through Adam's normalisation).
@pytest.mark.parametrize(
    "mode,accum,loss_type",
    [("multimodal", 1, "mse"), ("multimodal", 2, "mse"), ("baseline", 1, "mse"),
     ("baseline", 2, "mse"), ("multimodal", 1, "quantile")],
)
def test_trainer_matches_jax(tmp_path, mode, accum, loss_type):
    """20 series in batches of 8 (the last one padded; at accumulation 2 the second step
    has an all-padding micro-batch), 3 epochs with validation, same seed: per-epoch train
    and validation losses and the final trained parameters."""
    port, jdec, tree = _decoder_pair(seed=3)
    train, val = _samples(20, 1, 64), _samples(6, 2, 64)
    kw = _train_kwargs(gradient_accumulation_steps=accum, loss_type=loss_type)
    jt = JTrainer(jdec, jax.tree.map(jnp.asarray, tree), JArgs(output_dir=str(tmp_path / "j"), **kw),
                  train, val, mode, fuse_epochs=False)
    pt = MultimodalTrainer(port, TrainingArguments(output_dir=str(tmp_path / "p"), **kw),
                           train, val, mode, device="cpu")
    ours = [(pt.train_epoch(), pt.validate_epoch()) for _ in range(3)]
    ref = [(jt.train_epoch(), jt.validate_epoch()) for _ in range(3)]
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    assert pt.global_step == jt.global_step
    key = "fusion" if mode == "multimodal" else "adapter"
    assert pt.trainable_key == key
    ours_p, ref_p = _leaves(export_jax_params(pt.trainable_module)), _leaves(jax.device_get(jt.state.trainable))
    assert ours_p.keys() == ref_p.keys()
    for name in ref_p:
        np.testing.assert_allclose(ours_p[name], ref_p[name], atol=5e-4, err_msg=name)


def test_epoch_indices_and_quantile_objective_match_jax():
    for shuffle, accum in ((True, 2), (False, 1)):
        ours = build_epoch_indices(21, 8, shuffle, accum, 1, np.random.default_rng(5))
        ref = j_build_epoch_indices(21, 8, shuffle, accum, 1, np.random.default_rng(5))
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o, r)
    rng = np.random.default_rng(6)
    full = rng.normal(size=(4, 8, 10)).astype(np.float32)
    horizon = rng.normal(size=(4, 8)).astype(np.float32)
    weights = np.array([1, 1, 1, 0], np.float32)
    spec = TimesFM2p5Adapter(TimesFMConfig.tiny()).quantile_loss_spec
    assert spec == JAdapter(JConfig.tiny()).quantile_loss_spec
    ours = quantile_objective(torch.from_numpy(full), torch.from_numpy(horizon),
                              torch.from_numpy(weights), torch.tensor(24.0), spec)
    ref = j_quantile_objective(jnp.asarray(full), jnp.asarray(horizon), jnp.asarray(weights),
                               jnp.float32(24.0), spec)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


def test_checkpoints_rotate_keep_the_best_and_resume_the_run(tmp_path):
    """save_strategy "epoch" with a limit of 2, the best model, JAX-layout payloads, and a
    resume from epoch 1 that ends bit-equal to the uninterrupted run. A resumed trainer
    draws its epoch order afresh from the seed (as JAX's does); the test advances its
    generator past the two epochs already run, so the rest of the run sees the same order."""
    train, val = _samples(8, 1), _samples(4, 2)

    def make(out, epochs, **over):
        port, _, tree = _decoder_pair(seed=4)
        args = TrainingArguments(output_dir=str(out), **_train_kwargs(
            per_device_train_batch_size=4, num_train_epochs=epochs, save_strategy="epoch",
            save_total_limit=2, learning_rate=1e-2, **over))
        return MultimodalTrainer(port, args, train, val, "baseline", device="cpu")

    full = make(tmp_path / "full", 4, load_best_model_at_end=False)
    full.train()
    ckpts = sorted(p.name for p in full.args.checkpoint_dir.iterdir())
    assert ckpts == ["best_model.ckpt", "checkpoint_epoch_2.ckpt", "checkpoint_epoch_3.ckpt"]
    payload = load_checkpoint(full.args.checkpoint_dir / "checkpoint_epoch_3.ckpt")
    assert set(payload) == {"epoch", "global_step", "optimizer_state", "optimizer_is_fused",
                            "best_val_loss", "adapter_params"}
    assert payload["optimizer_is_fused"] is False
    assert payload["epoch"] == 3 and payload["global_step"] == 8
    assert set(payload["optimizer_state"]) == {"count", "mu", "nu"}
    assert int(payload["optimizer_state"]["count"]) == 8
    qkv = payload["adapter_params"]["stacked_xf"]["attn"]["qkv"]["kernel"]
    assert qkv.shape == (2, 32, 96)  # JAX layout: (L, in, out)
    assert _leaves(payload["optimizer_state"]["mu"]).keys() == _leaves(payload["adapter_params"]).keys()
    best = load_checkpoint(full.args.checkpoint_dir / "best_model.ckpt")
    assert best["best_val_loss"] == full.best_val_loss

    first = make(tmp_path / "part", 4)  # the same run, interrupted after epoch 1
    for epoch in range(2):
        first.current_epoch = epoch
        first.train_epoch()
        first.save_ckpt(first.validate_epoch())
    resumed = make(tmp_path / "part", 4)
    resumed.resume_from_checkpoint(first.args.checkpoint_dir / "checkpoint_epoch_1.ckpt")
    assert (resumed.start_epoch, resumed.global_step, resumed.optimizer.count) == (2, 4, 4)
    assert resumed.best_val_loss == first.best_val_loss
    for _ in range(2):
        resumed._rng.permutation(len(train))
    resumed.train()
    ours, ref = _leaves(export_jax_params(resumed.trainable_module)), _leaves(export_jax_params(full.trainable_module))
    for name in ref:
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)

    # load_best_model_at_end restores the best epoch's parameters.
    again = make(tmp_path / "best", 4, load_best_model_at_end=True)
    again.train()
    best_params = load_checkpoint(again.args.checkpoint_dir / "best_model.ckpt")["adapter_params"]
    for name, value in _leaves(best_params).items():
        np.testing.assert_array_equal(_leaves(export_jax_params(again.trainable_module))[name], value)


def test_trainer_raises_on_non_finite_loss(tmp_path):
    port, _, _ = _decoder_pair()
    bad = _samples(4, 3)
    bad[1]["horizon"][:] = np.inf
    args = TrainingArguments(output_dir=str(tmp_path), **_train_kwargs())
    trainer = MultimodalTrainer(port, args, bad, bad, "multimodal", device="cpu")
    with pytest.raises(FloatingPointError, match="Non-finite training loss at epoch 0"):
        trainer.train_epoch()


def test_host_gathered_epochs_match_device_staged(tmp_path):
    """Below the staging budget micro-batches are gathered on the host: same numbers."""
    losses = []
    for budget in (4 << 30, 0):
        port, _, _ = _decoder_pair(seed=5)
        args = TrainingArguments(output_dir=str(tmp_path / str(budget)), **_train_kwargs())
        trainer = MultimodalTrainer(port, args, _samples(12, 4), _samples(4, 5), "multimodal",
                                    device="cpu", max_device_dataset_bytes=budget)
        assert trainer._device_resident == (budget > 0)
        losses.append([trainer.train_epoch(), trainer.validate_epoch(), trainer.last_throughput > 0])
    assert losses[0] == losses[1]


def test_trainer_needs_cuda_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port, _, _ = _decoder_pair()
    args = TrainingArguments(output_dir=str(tmp_path), **_train_kwargs())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultimodalTrainer(port, args, _samples(4, 0), _samples(4, 1), "multimodal")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultimodalEvaluator(port)
    MultimodalTrainer(port, args, _samples(4, 0), _samples(4, 1), "multimodal", device="cpu")


@pytest.mark.parametrize(
    "knob,value",
    [("mesh", object()), ("shard_params_fn", lambda p, m: p)],
)
def test_trainer_refuses_unported_knobs(tmp_path, knob, value):
    """The parallel knobs are validated before anything is built: a mesh needs an
    initialised process group, and ``shard_params_fn`` needs a mesh to shard over (the
    mesh's own errors, the divisions and the sharding rules:
    tests/test_torch_port_parallel.py)."""
    port, _, _ = _decoder_pair()
    args = TrainingArguments(output_dir=str(tmp_path), **_train_kwargs())
    error, match = {"mesh": (RuntimeError, "process group"), "shard_params_fn": (ValueError, "needs a mesh")}[knob]
    with pytest.raises(error, match=match):
        MultimodalTrainer(port, args, _samples(4, 0), _samples(4, 1), "multimodal", device="cpu",
                          **{knob: value})


# ---------------------------------------------------------------------------
# evaluator, arguments, seed, logging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantile_metrics", [False, True])
def test_evaluator_matches_jax(quantile_metrics):
    """10 series in batches of 4 (the last padded by wrapping, weight 0): fp32, the same
    sums in another order."""
    port, jdec, tree = _decoder_pair(seed=6)
    data = _samples(10, 7)
    ours = MultimodalEvaluator(port, device="cpu").evaluate(data, batch_size=4, quantile_metrics=quantile_metrics)
    ref = JEvaluator(jdec).evaluate(jax.tree.map(jnp.asarray, tree), data, batch_size=4,
                                    quantile_metrics=quantile_metrics)
    assert ours.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(ours[name], ref[name], rtol=1e-5, err_msg=name)
    base = MultimodalEvaluator(port, device="cpu").evaluate(data, batch_size=4, multimodal=False)
    assert base["mse"] != ours["mse"]
    with pytest.raises(RuntimeError, match="empty"):
        MultimodalEvaluator(port, device="cpu").evaluate([])


def test_training_arguments_match_jax(tmp_path):
    cfg = tmp_path / "train.yml"
    cfg.write_text(f"output_dir: {tmp_path / 'o'}\nnum_train_epochs: 3\nwarmup_steps: 0.25\n"
                   "adam_moment_dtype: bfloat16\n")
    ours, ref = TrainingArguments.from_yaml(cfg), JArgs.from_yaml(cfg)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.checkpoint_dir.is_dir() and ours.logging_dir.is_dir()
    for total in (1, 7, 40):
        assert ours.get_warmup_steps(total) == ref.get_warmup_steps(total)
    with pytest.raises(ValueError, match="loss_type"):
        TrainingArguments(output_dir=str(tmp_path / "x"), loss_type="l1")


def test_set_seed_and_logger(tmp_path):
    set_seed(3)
    a = (torch.rand(2), np.random.rand(), random.random())
    set_seed(3)
    b = (torch.rand(2), np.random.rand(), random.random())
    assert torch.equal(a[0], b[0]) and a[1:] == b[1:]
    log = tmp_path / "logs" / "run.log"
    logger = setup_logger(log_file=log)
    assert setup_logger(log_file=log) is logger
    assert sum(isinstance(h, logging.FileHandler) for h in logger.handlers) == 1
    get_logger("trainer").info("hello")
    for h in logger.handlers:
        h.flush()
    assert "hello" in log.read_text()
