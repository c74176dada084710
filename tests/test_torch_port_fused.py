"""The fused optimizer and the fused multi-epoch path of the PyTorch port against JAX.

``FusedOptimizer`` against JAX's ``make_fused_adamw`` (following
``tests/test_optimization.py``), the checkpoint stamp that keeps fused and
chain optimizer states apart, and ``train_epochs_fused`` against the port's
per-epoch loop and JAX's fused run (following ``tests/test_trainer.py``):
best validation loss, the best checkpoint, the restored parameters, and a
non-finite loss. On the CPU the fused path runs each optimizer step
eagerly; on CUDA the same step is captured in a CUDA graph (driven by
``chip_smoke.py``). Tolerances are stated beside each test.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.models.decoder import MultimodalDecoder as JDecoder
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoderConfig as JDecoderConfig
from multimodal_timesfm_tpu.models.timesfm import TimesFM2p5Adapter as JAdapter
from multimodal_timesfm_tpu.models.timesfm import TimesFMConfig as JConfig
from multimodal_timesfm_tpu.training import optimization as jopt
from multimodal_timesfm_tpu.training.checkpoint import load_checkpoint as j_load_checkpoint
from multimodal_timesfm_tpu.training.trainer import MultimodalTrainer as JTrainer
from multimodal_timesfm_tpu.training_args import TrainingArguments as JArgs
from multimodal_timesfm_torch.models.bridge import export_jax_params, load_jax_params, random_jax_params
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
from multimodal_timesfm_torch.training import optimization as topt
from multimodal_timesfm_torch.training.checkpoint import load_checkpoint
from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
from multimodal_timesfm_torch.training_args import TrainingArguments

TEXT = 6


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


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_fused_adamw_matches_jax(moment_dtype):
    """Eight steps of ``FusedOptimizer`` against ``make_fused_adamw``, clipping triggered
    (gradients x100) on every third step and not on the others: parameters after every
    step within 1e-6 relative + 1e-7 (the same fp32 operations in the same order; the
    bias corrections' pow and the norm's sum may round apart), moments stored in the
    moment dtype and within 1e-5, and the step count."""
    schedule = jopt.make_schedule("cosine", 1e-2, 2, 12)
    jdt = jnp.bfloat16 if moment_dtype == "bfloat16" else None
    fused = jopt.make_fused_adamw(schedule, 0.01, 1.0, moment_dtype=jdt)
    rng = np.random.default_rng(1)
    shapes = [(8, 4), (3,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jparams = [jnp.asarray(p) for p in params]
    jstate = fused.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    opt = topt.make_fused_adamw(tparams, topt.make_schedule("cosine", 1e-2, 2, 12), 0.01, 1.0,
                                torch.bfloat16 if jdt is not None else None)
    clipped = 0
    for step in range(8):
        scale = 100.0 if step % 3 == 2 else 0.05
        grads = [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
        clipped += np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads)) >= 1.0
        jparams, jstate = fused.step([jnp.asarray(g) for g in grads], jstate, jparams)
        opt.step([torch.from_numpy(g) for g in grads])
        for ours, ref in zip(tparams, jparams):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    assert 0 < clipped < 8
    assert opt.count == int(jstate.count) == 8
    for ours, ref in zip(opt.mu + opt.nu, list(jstate.mu) + list(jstate.nu)):
        assert ours.dtype == (torch.bfloat16 if jdt is not None else torch.float32)
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32), rtol=1e-5, atol=1e-9)


def test_fused_adamw_matches_the_chain_without_clipping():
    """Below the clipping norm the fused stepper and the chain are the same math: four
    steps within 1e-6 relative of each other, as JAX pins its two forms."""
    rng = np.random.default_rng(2)
    params = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(4,)).astype(np.float32)]
    a = [torch.from_numpy(p.copy()) for p in params]
    b = [torch.from_numpy(p.copy()) for p in params]
    schedule = topt.make_schedule("linear", 1e-2, 1, 8)
    chain = topt.AdamW(a, schedule, 0.01, 10.0)
    fused = topt.make_fused_adamw(b, schedule, 0.01, 10.0)
    for _ in range(4):
        grads = [torch.from_numpy((rng.normal(size=p.shape) * 0.1).astype(np.float32)) for p in params]
        chain.step(grads)
        fused.step(grads)
        for x, y in zip(a, b):
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-6, atol=1e-8)


def _samples(n, seed, context=16, text=True, scale=1.0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = {
            "context": ((rng.normal(size=context) + np.sin(np.arange(context))) * scale).astype(np.float32),
            "horizon": (rng.normal(size=8) * scale).astype(np.float32),
            "metadata": {},
        }
        if text:
            s["text_embeddings"] = rng.normal(size=(context // 4, TEXT)).astype(np.float32)
        out.append(s)
    return out


def _args_kw(**over):
    kw = dict(
        per_device_train_batch_size=8, per_device_eval_batch_size=4, num_train_epochs=3,
        learning_rate=1e-3, lr_scheduler_type="linear", warmup_steps=1, weight_decay=0.01,
        max_grad_norm=1.0, eval_strategy="epoch", save_strategy="best", load_best_model_at_end=True,
        logging_strategy="no", seed=7,
    )
    kw.update(over)
    return kw


def _port(seed):
    decoder = MultimodalDecoder(TimesFM2p5Adapter(TimesFMConfig.tiny()),
                                MultimodalDecoderConfig(text_embedding_dims=TEXT), device="cpu")
    tree = random_jax_params(decoder, seed)
    load_jax_params(decoder, tree)
    return decoder, tree


@pytest.mark.parametrize("saved_fused", [False, True])
def test_fused_and_chain_checkpoints_refuse_each_other(tmp_path, saved_fused):
    """A checkpoint carries ``optimizer_is_fused``; resuming it under the other setting
    raises with JAX's message, under the same setting it resumes."""
    train, val = _samples(8, 1), _samples(4, 2)

    def make(out, fused):
        decoder, _ = _port(4)
        args = TrainingArguments(output_dir=str(out), **_args_kw(
            per_device_train_batch_size=4, num_train_epochs=2, save_strategy="epoch"))
        return MultimodalTrainer(decoder, args, train, val, "multimodal", device="cpu",
                                 fused_optimizer=fused)

    first = make(tmp_path / "a", saved_fused)
    first.train()
    path = first.args.checkpoint_dir / "checkpoint_epoch_0.ckpt"
    assert load_checkpoint(path)["optimizer_is_fused"] is saved_fused
    with pytest.raises(ValueError, match=f"written with the {'fused' if saved_fused else 'chain'} optimizer"
                       f".*fused_optimizer={saved_fused}"):
        make(tmp_path / "b", not saved_fused).resume_from_checkpoint(path)
    same = make(tmp_path / "c", saved_fused)
    same.resume_from_checkpoint(path)
    assert (same.start_epoch, same.optimizer.count) == (1, 2)


@pytest.fixture(scope="module", params=["multimodal", "baseline"])
def fused_runs(request):
    """One mode's three runs of ``train()`` from one tree and seed (20 series in batches
    of 8, the last padded; 12 validation series; save "best", the best restored): the
    port's per-epoch loop, the port's fused path, JAX's fused path."""
    mode = request.param
    text = mode == "multimodal"
    train, val = _samples(20, 5, text=text), _samples(12, 6, text=text)
    out = tempfile.mkdtemp()
    runs = {}
    for name, fuse in (("loop", False), ("fused", None)):
        decoder, tree = _port(9)
        trainer = MultimodalTrainer(decoder, TrainingArguments(output_dir=f"{out}/{name}", **_args_kw()),
                                    train, val, mode, device="cpu", fuse_epochs=fuse)
        assert trainer.fused_epochs_supported() == (fuse is None)
        trainer.train()
        runs[name] = (trainer, load_checkpoint(trainer.args.checkpoint_dir / "best_model.ckpt"))
    jdec = JDecoder(JAdapter(JConfig.tiny()), JDecoderConfig(text_embedding_dims=TEXT))
    jt = JTrainer(jdec, jax.tree.map(jnp.asarray, tree), JArgs(output_dir=f"{out}/j", **_args_kw()),
                  train, val, mode)
    assert jt.fused_epochs_supported()
    jt.train()
    runs["jax"] = (jt, j_load_checkpoint(jt.args.checkpoint_dir / "best_model.ckpt"))
    return mode, runs


def test_fused_epochs_match_the_per_epoch_loop(fused_runs):
    """On the CPU the fused path runs the loop's steps in the loop's order: the same best
    validation loss, best epoch and global step, and the same best checkpoint and restored
    parameters, to 1e-6 (the loop validates through the same device-staged path)."""
    mode, runs = fused_runs
    (loop, loop_ckpt), (fused, fused_ckpt) = runs["loop"], runs["fused"]
    key = "fusion_params" if mode == "multimodal" else "adapter_params"
    assert fused.global_step == loop.global_step == 9
    np.testing.assert_allclose(fused.best_val_loss, loop.best_val_loss, rtol=1e-6)
    assert fused_ckpt["epoch"] == loop_ckpt["epoch"]
    assert fused_ckpt["global_step"] == loop_ckpt["global_step"]
    for ours, ref in ((fused_ckpt[key], loop_ckpt[key]),
                      (export_jax_params(fused.trainable_module), export_jax_params(loop.trainable_module))):
        ref_leaves = _leaves(ref)
        for name, value in _leaves(ours).items():
            np.testing.assert_allclose(value, ref_leaves[name], rtol=1e-6, atol=1e-7, err_msg=name)


def test_fused_epochs_match_jax(fused_runs):
    """The port's fused run against JAX's (``train()`` on its fused path): best validation
    loss within rtol 2e-3, the same best epoch, and the best checkpoint's and restored
    parameters within 5e-4 (the bounds of tests/test_trajectory_parity.py). The best
    checkpoint of a fused run is stamped as carrying the end-of-run optimizer state."""
    mode, runs = fused_runs
    (fused, fused_ckpt), (jt, j_ckpt) = runs["fused"], runs["jax"]
    key = "fusion_params" if mode == "multimodal" else "adapter_params"
    np.testing.assert_allclose(fused.best_val_loss, jt.best_val_loss, rtol=2e-3)
    assert fused_ckpt["epoch"] == j_ckpt["epoch"]
    assert fused_ckpt["global_step"] == j_ckpt["global_step"]
    assert fused_ckpt["optimizer_state_is_final"] is True and j_ckpt["optimizer_state_is_final"] is True
    for ours, ref in ((fused_ckpt[key], j_ckpt[key]),
                      (export_jax_params(fused.trainable_module), jax.device_get(jt.state.trainable))):
        ref_leaves = _leaves(ref)
        got = _leaves(ours)
        assert got.keys() == ref_leaves.keys()
        for name, value in got.items():
            np.testing.assert_allclose(value, ref_leaves[name], atol=5e-4, err_msg=name)


def test_resuming_a_fused_best_checkpoint_warns(fused_runs, tmp_path):
    """The best checkpoint of a fused run resumes with a warning that its optimizer state
    is the end of the run's, as JAX's does."""
    mode, runs = fused_runs
    fused, _ = runs["fused"]
    decoder, _ = _port(9)
    text = mode == "multimodal"
    again = MultimodalTrainer(decoder, TrainingArguments(output_dir=str(tmp_path), **_args_kw()),
                              _samples(20, 5, text=text), _samples(12, 6, text=text), mode, device="cpu")
    with pytest.warns(UserWarning, match="optimizer state is end-of-run"):
        again.resume_from_checkpoint(fused.args.checkpoint_dir / "best_model.ckpt")
    assert again.optimizer.count == 9


def test_train_epochs_fused_returns_losses_like_jax(tmp_path):
    """``train_epochs_fused`` returns (E, micro-batches) train losses and (E,) validation
    losses; the trailing all-padding micro-batch of an accumulation step is run with zero
    weight and left out, as in JAX (gradient accumulation 2, three batches): both within
    rtol 2e-3 of JAX's."""
    train, val = _samples(20, 7), _samples(6, 8)
    kw = _args_kw(gradient_accumulation_steps=2, save_strategy="no", load_best_model_at_end=False)
    decoder, tree = _port(12)
    pt = MultimodalTrainer(decoder, TrainingArguments(output_dir=str(tmp_path / "p"), **kw),
                           train, val, "multimodal", device="cpu")
    jdec = JDecoder(JAdapter(JConfig.tiny()), JDecoderConfig(text_embedding_dims=TEXT))
    jt = JTrainer(jdec, jax.tree.map(jnp.asarray, tree), JArgs(output_dir=str(tmp_path / "j"), **kw),
                  train, val, "multimodal")
    ours, ref = pt.train_epochs_fused(3), jt.train_epochs_fused(3)
    assert ours[0].shape == (3, 3) and ours[1].shape == (3,)
    np.testing.assert_allclose(ours[0], ref[0], rtol=2e-3)
    np.testing.assert_allclose(ours[1], ref[1], rtol=2e-3)
    assert pt.global_step == jt.global_step == 6


def test_fused_epochs_raise_on_non_finite_loss(tmp_path):
    """Series scaled by 1e30 overflow: the fused run raises naming the epoch."""
    samples = _samples(16, 0, text=False, scale=1e30)
    decoder, _ = _port(0)
    args = TrainingArguments(output_dir=str(tmp_path), **_args_kw(save_strategy="no", load_best_model_at_end=False))
    trainer = MultimodalTrainer(decoder, args, samples, samples[:8], "baseline", device="cpu")
    assert trainer.fused_epochs_supported()
    with pytest.raises(FloatingPointError, match="Non-finite training loss at epoch 0"):
        trainer.train()
