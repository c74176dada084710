"""The sweep slice of the PyTorch port against the JAX package: the functional AdamW, the
vectorized trials and their evaluation, the local sweep engine, the split CLI, the sweep
library and the tune CLIs, and the trainer's ``wandb_run`` logging.

At tiny widths (2 layers, 2 heads, model dims 32), inputs from numpy seeds, weights drawn
once with numpy (``bridge.random_jax_params``) and loaded into both packages. Tolerances,
stated beside each test: the functional AdamW against the port's chain within 1e-6
relative (the same fp32 operations); the port against JAX within the repo's trajectory
ceiling (losses rtol 2e-3, parameters atol 5e-4: fp32 noise carried through Adam's
normalisation); the port against itself (a T=1 run against the trainer, T trials against
T runs) within 1e-5 relative (only the GEMMs' row counts differ).
"""

import csv
import dataclasses
import json
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.time_mmd.sweep_lib as jsweep
from examples.time_mmd.configs.forecast import ForecastConfig as JForecastConfig
from examples.time_mmd.configs.model import ModelConfig as JModelConfig
from examples.time_mmd.data.time_mmd_dataset import TimeMmdDataset as JTimeMmdDataset
from multimodal_timesfm_tpu.data.dataset import PreprocessedDataset as JPreprocessedDataset
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoder as JDecoder
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoderConfig as JDecoderConfig
from multimodal_timesfm_tpu.models.timesfm import TimesFM2p5Adapter as JAdapter
from multimodal_timesfm_tpu.models.timesfm import TimesFMConfig as JConfig
from multimodal_timesfm_tpu.training import vectorized as jvec
from multimodal_timesfm_tpu.training.trainer import MultimodalTrainer as JTrainer
from multimodal_timesfm_tpu.training_args import TrainingArguments as JArgs
from multimodal_timesfm_tpu.utils import tracking as jtracking
from multimodal_timesfm_torch import tune, tune_baseline
from multimodal_timesfm_torch.data.collate import StackedDataset
from multimodal_timesfm_torch.data.preprocess import PreprocessPipeline
from multimodal_timesfm_torch.models.bridge import export_jax_params, load_jax_params, random_jax_params
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
from multimodal_timesfm_torch.models.layers import fold_frozen_tree_affines
from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
from multimodal_timesfm_torch.time_mmd import split as tsplit
from multimodal_timesfm_torch.time_mmd import sweep_lib
from multimodal_timesfm_torch.time_mmd.dataset import TimeMmdDataset
from multimodal_timesfm_torch.training import optimization as topt
from multimodal_timesfm_torch.training import vectorized as tvec
from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
from multimodal_timesfm_torch.training_args import TrainingArguments
from multimodal_timesfm_torch.utils import tracking as ttracking
from tests.test_torch_port_data import _assert_same_samples, _write_domain

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    """PyTorch's per-sample vmap fallback raises instead of warning from C++: every op on
    the vectorized path has a batching rule or a vmap rule of the port's."""
    torch._C._functorch._set_vmap_fallback_enabled(False)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(True)

CONTEXT, HORIZON, TEXT = 16, 8, 6
LOSS_RTOL, PARAM_ATOL = 2e-3, 5e-4  # the port against JAX (tests/test_trajectory_parity.py's ceiling)
SELF_RTOL = 1e-5  # the port against itself


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree, np.float32)}
    out = {}
    for key, value in items:
        out.update(_leaves(value, f"{prefix}/{key}"))
    return out


def _port_decoder(text=TEXT, seed=0, cfg=None):
    decoder = MultimodalDecoder(
        TimesFM2p5Adapter(cfg or TimesFMConfig.tiny()), MultimodalDecoderConfig(text_embedding_dims=text),
        device="cpu",
    )
    tree = random_jax_params(decoder, seed)
    load_jax_params(decoder, tree)
    return decoder, tree


def _data(n, seed, text=True):
    rng = np.random.default_rng(seed)
    out = {
        "context": rng.normal(size=(n, CONTEXT)).astype(np.float32),
        "horizon": rng.normal(size=(n, HORIZON)).astype(np.float32),
    }
    if text:
        out["text"] = rng.normal(size=(n, CONTEXT // 4, TEXT)).astype(np.float32)
    return out


def _hp(lrs, wds, warmups):
    return {"learning_rate": np.asarray(lrs), "weight_decay": np.asarray(wds),
            "warmup_steps": np.asarray(warmups, np.float32)}


# ---------------------------------------------------------------------------
# the functional AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "cosine"])
@pytest.mark.parametrize("lr,wd,warmup", [(1e-2, 0.01, 3), (3e-3, 0.0, 0)])
def test_functional_adamw_matches_port_adamw(kind, lr, wd, warmup):
    """``adamw_update`` + ``schedule_scale`` against the port's ``AdamW`` (the optax chain)
    over 12 steps, clipping triggered on two of every three: parameters within 1e-6
    relative + 1e-7 after every step (the same fp32 operations), moments and the count."""
    total = 12
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 5), "b": (7,)}
    start = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    chain_params = [torch.from_numpy(start[k].copy()) for k in shapes]
    chain = topt.AdamW(chain_params, topt.make_schedule(kind, lr, warmup, total), wd, 1.0)
    params = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    state = tvec.adamw_init(params)
    for step in range(total):
        grads = {k: torch.from_numpy((rng.normal(size=s) * (3.0 if step % 3 else 0.1)).astype(np.float32))
                 for k, s in shapes.items()}
        chain.step(list(grads.values()))
        step_lr = lr * tvec.schedule_scale(state["count"], float(warmup), total, kind)
        params, state = tvec.adamw_update(grads, state, params, step_lr, wd, max_grad_norm=1.0)
        for ours, ref in zip(params.values(), chain_params):
            np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)
    for ours, ref in zip(state["mu"].values(), chain.mu):
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-6, atol=1e-9)
    assert int(state["count"]) == chain.count == total


# ---------------------------------------------------------------------------
# vectorized trials: against JAX, the trainer, independent runs
# ---------------------------------------------------------------------------


def _port_trainables(decoder, key, results, t):
    child = getattr(decoder, key)
    return _leaves(export_jax_params(child, {p: results.best_trainable[n][t] for n, p in child.named_parameters()}))


@pytest.mark.parametrize("loss_type", ["mse", "quantile"])
@pytest.mark.parametrize("mode", ["multimodal", "baseline"])
def test_vectorized_trials_match_jax(mode, loss_type):
    """Two trials with their own rates, decays, warmups and epoch orders (seed_stride 1),
    three epochs, then ``evaluate_vectorized``: per-micro-batch losses, validation losses,
    best validation loss and epoch, the best trained tensors, and test MSE/MAE against
    JAX's ``run_vectorized_trials`` and ``evaluate_vectorized`` on the same weights.

    Baseline mode trains at a tenth of the rates: the key bias's gradient is zero up to
    rounding (softmax ignores a shift of every logit), and Adam normalises that noise to
    about +-lr a step, so its drift between the packages grows with lr (1.7e-3 at 1e-2
    after nine steps, 1.8e-4 at 1e-3, with the losses 2e-7 apart at both)."""
    multimodal = mode == "multimodal"
    key = "fusion" if multimodal else "adapter"
    decoder, tree = _port_decoder()
    jdec = JDecoder(JAdapter(JConfig.tiny()), JDecoderConfig(text_embedding_dims=TEXT))
    jparams = jax.tree.map(jnp.asarray, tree)
    train, val, test = _data(20, 1, multimodal), _data(12, 2, multimodal), _data(10, 3, multimodal)
    hp = _hp([1e-2, 3e-3] if multimodal else [1e-3, 3e-4], [0.01, 0.0], [2.0, 0.0])
    kw = dict(horizon_len=HORIZON, batch_size=8, num_epochs=3, scheduler="cosine", seed=4, loss_type=loss_type,
              trainable_key=key)

    jfrozen = {k: v for k, v in jparams.items() if k != key}
    jres = jvec.run_vectorized_trials(jdec, jfrozen, jvec.stack_trainables([jparams[key]] * 2), train, val, hp, **kw)
    jmse, jmae = jvec.evaluate_vectorized(jdec, jfrozen, jres.best_trainable, test, horizon_len=HORIZON,
                                          batch_size=4, trainable_key=key)
    inits = tvec.replicate_trainables(dict(getattr(decoder, key).named_parameters()), 2)
    res = tvec.run_vectorized_trials(decoder, inits, train, val, hp, **kw)
    mse, mae = tvec.evaluate_vectorized(decoder, res.best_trainable, test, horizon_len=HORIZON, batch_size=4,
                                        trainable_key=key)

    assert res.train_losses.shape == jres.train_losses.shape == (2, 3, 3)
    np.testing.assert_allclose(res.train_losses, jres.train_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(res.val_losses, jres.val_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(res.best_val, jres.best_val, rtol=LOSS_RTOL)
    np.testing.assert_array_equal(res.best_epoch, jres.best_epoch)
    for t in range(2):
        ours = _port_trainables(decoder, key, res, t)
        ref = _leaves(jax.tree.map(lambda x: x[t], jres.best_trainable))
        assert ours.keys() == ref.keys()
        for name in ref:
            np.testing.assert_allclose(ours[name], ref[name], atol=PARAM_ATOL, err_msg=name)
    np.testing.assert_allclose(mse, jmse, rtol=LOSS_RTOL)
    np.testing.assert_allclose(mae, jmae, rtol=LOSS_RTOL)


def test_vectorized_accumulation_matches_jax():
    """Gradient accumulation over two micro-batches (the last step's second one all
    padding, as JAX's scan runs it), two trials, linear schedule: losses, validation
    losses and best trained tensors against JAX's within the trajectory ceiling."""
    decoder, tree = _port_decoder()
    jdec = JDecoder(JAdapter(JConfig.tiny()), JDecoderConfig(text_embedding_dims=TEXT))
    jparams = jax.tree.map(jnp.asarray, tree)
    train, val = _data(20, 5), _data(12, 6)
    hp = _hp([1e-2, 4e-3], [0.01, 0.05], [1.0, 0.0])
    kw = dict(horizon_len=HORIZON, batch_size=4, num_epochs=2, accum=2, scheduler="linear", seed=2)
    jres = jvec.run_vectorized_trials(jdec, {"adapter": jparams["adapter"]},
                                      jvec.stack_trainables([jparams["fusion"]] * 2), train, val, hp, **kw)
    res = tvec.run_vectorized_trials(decoder, tvec.replicate_trainables(dict(decoder.fusion.named_parameters()), 2),
                                     train, val, hp, **kw)
    assert res.train_losses.shape == jres.train_losses.shape == (2, 2, 5)
    np.testing.assert_allclose(res.train_losses, jres.train_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(res.val_losses, jres.val_losses, rtol=LOSS_RTOL)
    for t in range(2):
        ours = _port_trainables(decoder, "fusion", res, t)
        ref = _leaves(jax.tree.map(lambda x: x[t], jres.best_trainable))
        for name in ref:
            np.testing.assert_allclose(ours[name], ref[name], atol=PARAM_ATOL, err_msg=name)


def test_single_trial_matches_trainer(tmp_path):
    """A T=1 run against ``MultimodalTrainer.train_epochs_fused`` on the same weights, the
    same seed (so the same epoch orders) and the same affine fold: validation losses,
    best validation loss and the best trained tensors within 1e-5 relative."""
    decoder, tree = _port_decoder()
    train, val = _data(20, 1), _data(12, 2)
    args = TrainingArguments(
        output_dir=str(tmp_path), per_device_train_batch_size=8, per_device_eval_batch_size=8,
        num_train_epochs=3, learning_rate=1e-2, weight_decay=0.01, lr_scheduler_type="linear",
        warmup_steps=2, eval_strategy="epoch", save_strategy="best", logging_strategy="no", seed=7,
    )

    def stacked(d):
        return StackedDataset(d["context"], d["horizon"], d["text"], [{}] * len(d["context"]))

    trainer = MultimodalTrainer(decoder, args, stacked(train), stacked(val), "multimodal", device="cpu")
    _, trainer_vals = trainer.train_epochs_fused(3)

    vdecoder, _ = _port_decoder()
    fold_frozen_tree_affines(vdecoder.adapter)  # as the trainer folds its frozen copy
    res = tvec.run_vectorized_trials(
        vdecoder, tvec.stack_trainables([dict(vdecoder.fusion.named_parameters())]), train, val,
        _hp([1e-2], [0.01], [2.0]), horizon_len=HORIZON, batch_size=8, num_epochs=3, scheduler="linear", seed=7,
    )
    np.testing.assert_allclose(res.val_losses[0], trainer_vals, rtol=SELF_RTOL)
    np.testing.assert_allclose(res.best_val[0], trainer._fused_best["val"], rtol=SELF_RTOL)
    for (name, best), ref in zip(res.best_trainable.items(), trainer._fused_best["trainable"]):
        np.testing.assert_allclose(best[0].numpy(), ref.numpy(), rtol=SELF_RTOL, atol=1e-7, err_msg=name)


def test_trials_match_independent_runs():
    """Three trials (seed_stride 1) against three T=1 runs, trial t's seed and
    hyperparameters each: losses and best trained tensors within 1e-5 relative."""
    decoder, _ = _port_decoder()
    train, val = _data(20, 1), _data(12, 2)
    init = {k: v.detach().clone() for k, v in decoder.fusion.named_parameters()}
    lrs, wds, warmups = [1e-2, 5e-3, 2e-3], [0.01, 0.0, 0.1], [2.0, 0.0, 1.0]
    kw = dict(horizon_len=HORIZON, batch_size=8, num_epochs=2, scheduler="linear", seed_stride=1)
    res = tvec.run_vectorized_trials(decoder, tvec.replicate_trainables(init, 3), train, val,
                                     _hp(lrs, wds, warmups), seed=3, **kw)
    for t in range(3):
        one = tvec.run_vectorized_trials(decoder, tvec.replicate_trainables(init, 1), train, val,
                                         _hp(lrs[t:t + 1], wds[t:t + 1], warmups[t:t + 1]), seed=3 + t, **kw)
        np.testing.assert_allclose(res.train_losses[t], one.train_losses[0], rtol=SELF_RTOL)
        np.testing.assert_allclose(res.val_losses[t], one.val_losses[0], rtol=SELF_RTOL)
        for name, best in res.best_trainable.items():
            np.testing.assert_allclose(best[t].numpy(), one.best_trainable[name][0].numpy(), rtol=SELF_RTOL,
                                       atol=1e-7, err_msg=name)
    assert res.graph_captures == res.graph_replays == 0  # the CPU runs each step eagerly


def test_program_cache_is_bounded_and_mesh_is_refused():
    """Nine structures leave eight trial programs cached; ``release_programs`` drops a
    model's; ``mesh`` raises naming ROADMAP item 10."""
    decoder, _ = _port_decoder()
    train, val = _data(16, 1), _data(8, 2)
    init = dict(decoder.fusion.named_parameters())
    tvec._PROGRAMS.clear()
    for batch in range(4, 13):
        tvec.run_vectorized_trials(decoder, tvec.replicate_trainables(init, 1), train, val, _hp([1e-3], [0.0], [0.0]),
                                   horizon_len=HORIZON, batch_size=batch, num_epochs=1)
    assert len(tvec._PROGRAMS) == tvec._CACHE_MAX == 8
    tvec.release_programs(decoder)
    assert not tvec._PROGRAMS
    with pytest.raises(NotImplementedError, match="item 10"):
        tvec.run_vectorized_trials(decoder, init, train, val, _hp([1e-3], [0.0], [0.0]), horizon_len=HORIZON,
                                   batch_size=8, num_epochs=1, mesh=object())
    with pytest.raises(NotImplementedError, match="item 10"):
        tvec.evaluate_vectorized(decoder, init, val, horizon_len=HORIZON, batch_size=8, mesh=object())
    assert tvec.vectorized_max_trials(800_000_000, 80 << 30) == 16
    assert tvec.vectorized_max_trials(800_000_000, 16 << 30) == 3  # JAX's v5e figure


# ---------------------------------------------------------------------------
# the local sweep engine
# ---------------------------------------------------------------------------

SPACE = {
    "method": "random",
    "metric": {"name": "test/mse", "goal": "minimize"},
    "parameters": {
        "num_fusion_layers": {"value": 1},
        "batch_size": {"values": [4, 8, 16]},
        "learning_rate": {"distribution": "log_uniform_values", "min": "1e-6", "max": 1e-2},
        "warmup_steps": {"distribution": "uniform", "min": 0.0, "max": 0.1},
        "fusion_hidden_dim": {"distribution": "int_uniform", "min": 256, "max": 2048},
        "weight_decay": {"min": 1e-4, "max": 1e-1},
        "depth": {"min": 1, "max": 4},
    },
}


@pytest.mark.parametrize("method", ["random", "bayes"])
def test_local_sweep_matches_jax(tmp_path, method):
    """The same 16 configs from the same seed, the bayes engine fed the same observations
    (TPE from the 11th trial on); the durable state reloads into both engines alike."""
    space = {**SPACE, "method": method}
    ours = ttracking.LocalSweep(space, tmp_path / "ours", seed=3)
    ref = jtracking.LocalSweep(space, tmp_path / "ref", seed=3)
    for _ in range(16):
        a, b = ours.sample(), ref.sample()
        assert a == b
        value = (np.log(a["learning_rate"]) + 9.0) ** 2 + a["batch_size"] / 16
        ours.observe(a, value)
        ref.observe(b, value)
    again = ttracking.LocalSweep(space, tmp_path / "ours", seed=3)
    assert again._observations == jtracking.LocalSweep(space, tmp_path / "ref", seed=3)._observations


def test_local_sweep_resume_numbering_and_agent_match_jax(tmp_path):
    """A results log with local-0..local-4 and junk lines: both resume at 5 and draw the
    same fresh stream; the agent's run ids, claimed records and failure handling agree."""
    for name in ("ours", "ref"):
        out = tmp_path / name
        out.mkdir()
        lines = [json.dumps({"run_id": f"local-{i}", "event": "trial_start"}) for i in range(5)]
        (out / "sweep_results.jsonl").write_text("\n".join(lines + ["{not json", '{"run_id": "other"}']) + "\n")
    ours = ttracking.LocalSweep(SPACE, tmp_path / "ours", seed=1)
    ref = jtracking.LocalSweep(SPACE, tmp_path / "ref", seed=1)
    assert ours.next_trial_index() == ref.next_trial_index() == 5
    assert [ours.sample() for _ in range(3)] == [ref.sample() for _ in range(3)]

    def trial(run):
        if run.config.batch_size == 8:
            raise RuntimeError("boom")
        run.log({"test/mse": float(run.config.learning_rate)}, step=1)

    ours.agent(trial, count=4)
    ref.agent(trial, count=4)

    def records(name):
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in (tmp_path / name / "sweep_results.jsonl").read_text().splitlines()[7:]]

    assert records("ours") == records("ref")
    assert ours._observations == ref._observations
    with pytest.raises(RuntimeError, match="All 2 sweep trial"):
        ttracking.LocalSweep(SPACE, tmp_path / "fail", seed=0).agent(lambda run: 1 / 0, count=2)


# ---------------------------------------------------------------------------
# the split CLI
# ---------------------------------------------------------------------------

SPLIT_CASES = {"EnvA": "unsorted_dates", "EnvB": "integer_years", "EnvC": "na_strings",
               "EnvD": "interior_nan_inf", "EnvE": "datetime", "Health_AFR": "health_afr"}


def _split_tree(root):
    rng = np.random.default_rng(11)
    for domain, case in SPLIT_CASES.items():
        _write_domain(root, domain, rng, n=120, case=case, date_col="date" if domain == "Health_AFR" else "start_date")
    _write_domain(root, "NoDate", rng, n=40, date_col="when")  # the refusal: no start-date column


def test_split_cli_matches_jax_script(tmp_path):
    """The port's split CLI and ``scripts/split_time_mmd_datasets.py`` (in a subprocess) on
    copies of one tree: the same split directories and textual bytes, and the windows each
    package's loader reads from each output equal (bit for bit) for every split, plain and
    augmented; the same refusals (ratios summing to 1, a missing date column, a missing
    domain) and the same skip of existing outputs."""
    ours_root, ref_root = tmp_path / "ours", tmp_path / "ref"
    _split_tree(ours_root)
    _split_tree(ref_root)
    flags = ["--train-ratio", "0.5", "--val-ratio", "0.25"]
    assert tsplit.main(["--data-path", str(ours_root), *flags]) == 0
    script = [sys.executable, str(REPO / "scripts" / "split_time_mmd_datasets.py")]
    done = subprocess.run([*script, "--data-path", str(ref_root), *flags], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]

    def listing(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*.csv"))

    assert listing(ours_root) == listing(ref_root)
    assert not (ours_root / "numerical" / "NoDate_train").exists()
    for path in (ours_root / "textual").rglob("*.csv"):
        assert path.read_bytes() == (ref_root / path.relative_to(ours_root)).read_bytes()
    for domain in SPLIT_CASES:
        for split in ("train", "val", "test"):
            name = f"{domain}_{split}"
            for augment in (False, True):
                ours = list(TimeMmdDataset(ours_root, name, 4, CONTEXT, HORIZON, augment=augment))
                ref = list(JTimeMmdDataset(ref_root, name, 4, CONTEXT, HORIZON, augment=augment))
                cross = list(TimeMmdDataset(ref_root, name, 4, CONTEXT, HORIZON, augment=augment))
                if split == "train":
                    assert ours
                if ours or ref:
                    _assert_same_samples(ours, ref)
                    _assert_same_samples(cross, ref)

    # Refusals and skips, with the JAX script's exit codes.
    bad = ["--data-path", str(ours_root), "--train-ratio", "0.75", "--val-ratio", "0.25"]
    assert tsplit.main(bad) == 1
    ref_bad = subprocess.run([*script, *bad], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert ref_bad.returncode == 1
    train_csv = ours_root / "numerical" / "EnvA_train" / "EnvA_train.csv"
    before = train_csv.read_bytes()
    assert tsplit.main(["--data-path", str(ours_root), "--train-ratio", "0.3", "--val-ratio", "0.3",
                        "--domains", "EnvA", "Missing"]) == 0
    assert train_csv.read_bytes() == before  # existing outputs are kept without --force-rebuild
    assert tsplit.main(["--data-path", str(ours_root), "--train-ratio", "0.3", "--val-ratio", "0.3",
                        "--domains", "EnvA", "--force-rebuild"]) == 0
    with open(train_csv, newline="") as f:
        assert sum(1 for _ in csv.reader(f)) - 1 == int(120 * 0.3)


# ---------------------------------------------------------------------------
# the sweep library and the tune CLIs
# ---------------------------------------------------------------------------

SWEEP_TEXT = 8


@pytest.fixture(scope="module")
def sweep_tree(tmp_path_factory):
    """Caches of the fixed fold (train augmented, val, test) with random embeddings, the
    tiny model and forecast configs as JSON, and a sweep space with fixed structure."""
    root = tmp_path_factory.mktemp("sweep")
    cache = root / "cache"
    pipeline = PreprocessPipeline(cache)
    rng = np.random.default_rng(21)
    stamp = {"text_encoder": {"encoder": "Synthetic", "is_pretrained": True}}
    for i, domain in enumerate(sweep_lib.FOLD_DOMAINS):
        for split, n in (("train", 6 + i), ("val", 3), ("test", 2 + i % 2)):
            path = pipeline.get_path("time_mmd", f"{domain}_{split}", "english", 4, CONTEXT, HORIZON,
                                     augment=split == "train")
            samples = [{
                "context": rng.normal(size=CONTEXT).astype(np.float32),
                "horizon": rng.normal(size=HORIZON).astype(np.float32),
                "text_embeddings": rng.normal(size=(CONTEXT // 4, SWEEP_TEXT)).astype(np.float32),
                "metadata": {"domain": domain, "index": j, **stamp},
            } for j in range(n)]
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(pickle.dumps(samples))
    arch = dataclasses.asdict(TimesFMConfig.tiny())
    arch.pop("compute_dtype")
    arch["quantiles"] = list(arch["quantiles"])
    (root / "model.json").write_text(json.dumps({
        "adapter": {"type": "timesfm", "patch_len": 4, "arch": arch},
        "fusion": {"text_encoder_type": "english", "text_embedding_dims": SWEEP_TEXT},
    }))
    (root / "forecast.json").write_text(json.dumps({"context_len": CONTEXT, "horizon_len": HORIZON}))
    (root / "sweep.json").write_text(json.dumps({
        "method": "bayes", "metric": {"name": "test/mse", "goal": "minimize"},
        "parameters": {
            "num_fusion_layers": {"value": 1}, "batch_size": {"values": [8]}, "num_epochs": {"values": [2]},
            "learning_rate": {"distribution": "log_uniform_values", "min": 1e-4, "max": 1e-2},
            "lr_scheduler_type": {"values": ["cosine"]},
            "warmup_steps": {"distribution": "uniform", "min": 0.0, "max": 0.1},
            "weight_decay": {"distribution": "log_uniform_values", "min": 1e-4, "max": 1e-2},
            "gradient_accumulation_steps": {"values": [1]},
        },
    }))
    return root


def _jax_init_from_port(decoder, pretrained_dir, seed):
    """JAX ``init_decoder_params`` replaced: the port's numpy draw for the twin decoder,
    so both packages' sweeps start from the same weights."""
    arch = {f.name: getattr(decoder.adapter.config, f.name) for f in dataclasses.fields(TimesFMConfig)
            if f.name != "compute_dtype"}
    cfg = decoder.config
    twin = MultimodalDecoder(
        TimesFM2p5Adapter(TimesFMConfig(**arch)),
        MultimodalDecoderConfig(cfg.text_embedding_dims, cfg.num_fusion_layers, tuple(cfg.fusion_hidden_dims)),
        device="cpu",
    )
    return jax.tree.map(jnp.asarray, random_jax_params(twin, seed))


def _results(path):
    """{run_id: {key: value}} of a sweep_results.jsonl's metric records."""
    out = {}
    for line in Path(path).read_text().splitlines():
        rec = json.loads(line)
        if "val/best_loss" in rec or "error" in rec:
            out[rec["run_id"]] = {k: v for k, v in rec.items() if k not in ("run_id", "time")}
    return out


@pytest.mark.parametrize("mode", ["multimodal", "baseline"])
def test_tune_cli_and_sweep_lib_match_jax(sweep_tree, tmp_path, monkeypatch, mode):
    """``python -m multimodal_timesfm_torch.tune`` (or ``tune_baseline``) in-process, offline,
    sequential and ``--vectorized``, against JAX's ``train_and_evaluate_many`` on the same
    caches and the same sampled configs: the same result keys per run, and
    ``val/best_loss``, ``test/mse``, ``test/mae`` within rtol 2e-3; the vectorized run's
    TPE state holds each trial's ``test/mse``."""
    main = tune.main if mode == "multimodal" else tune_baseline.main
    common = ["--sweep-config", str(sweep_tree / "sweep.json"), "--count", "2",
              "--model-config", str(sweep_tree / "model.json"),
              "--forecast-config", str(sweep_tree / "forecast.json"), "--cache-dir", str(sweep_tree / "cache"),
              "--offline", "--seed", "0", "--device", "cpu"]
    seq_dir, vec_dir = tmp_path / "seq", tmp_path / "vec"
    assert main([*common, "--output-dir", str(seq_dir)]) == 0
    assert main([*common, "--output-dir", str(vec_dir), "--vectorized"]) == 0
    seq, vec = _results(seq_dir / "sweep_results.jsonl"), _results(vec_dir / "sweep_results.jsonl")

    configs = [json.loads(line)["config"] for line in (vec_dir / "sweep_results.jsonl").read_text().splitlines()
               if json.loads(line).get("event") == "trial_start"]
    runs = [jtracking.LocalRun(f"local-{i}", c, tmp_path / "jax" / "sweep_results.jsonl")
            for i, c in enumerate(configs)]
    monkeypatch.setattr(jsweep, "init_decoder_params", _jax_init_from_port)
    jsweep.train_and_evaluate_many(
        runs, JArgs(output_dir=str(tmp_path / "jax"), logging_strategy="epoch", eval_strategy="epoch",
                    save_strategy="best", seed=0),
        JModelConfig.from_yaml(sweep_tree / "model.json"), JForecastConfig.from_yaml(sweep_tree / "forecast.json"),
        sweep_tree / "cache", {"train"}, None, mode=mode,
    )
    ref = _results(tmp_path / "jax" / "sweep_results.jsonl")
    assert set(ref) == set(seq) == set(vec) == {"local-0", "local-1"}
    for run_id, rec in ref.items():
        assert set(vec[run_id]) == set(rec) == {"step", "val/best_loss", "test/mse", "test/mae"}
        assert set(seq[run_id]) == set(rec)
        assert seq[run_id]["step"] == vec[run_id]["step"] == rec["step"]
        for key in ("val/best_loss", "test/mse", "test/mae"):
            np.testing.assert_allclose([seq[run_id][key], vec[run_id][key]], rec[key], rtol=LOSS_RTOL,
                                       err_msg=f"{run_id} {key}")
    state = [json.loads(line) for line in (vec_dir / "sweep_state.jsonl").read_text().splitlines()]
    assert [s["value"] for s in state] == [vec[f"local-{i}"]["test/mse"] for i in range(2)]


def test_vectorized_group_over_budget_is_refused(sweep_tree, tmp_path, monkeypatch, caplog):
    """A baseline group larger than ``vectorized_max_trials`` allows logs the budget error
    to each of its runs; with every trial failed the sweep raises, as in JAX."""
    monkeypatch.setattr(tvec, "device_hbm_bytes", lambda default=0: 1 << 20)
    runs = [ttracking.LocalRun(f"local-{i}", {"batch_size": 8, "num_epochs": 1}, tmp_path / "r.jsonl")
            for i in range(2)]
    with pytest.raises(RuntimeError, match="All 2 vectorized sweep trial"):
        sweep_lib.train_and_evaluate_many(
            runs, TrainingArguments(output_dir=str(tmp_path), seed=0),
            sweep_lib.ModelConfig.from_yaml(sweep_tree / "model.json"),
            sweep_lib.ForecastConfig.from_yaml(sweep_tree / "forecast.json"),
            sweep_tree / "cache", {"train"}, None, mode="baseline", device="cpu",
        )
    assert all("exceeds the device budget" in run.summary["error"] for run in runs)
    with pytest.raises(NotImplementedError, match="item 10"):
        sweep_lib.train_and_evaluate_many(runs, None, None, None, None, set(), None, mesh=object())


# ---------------------------------------------------------------------------
# wandb_run logging
# ---------------------------------------------------------------------------


class _Run:
    """A W&B run stand-in: records what the trainer logs."""

    def __init__(self):
        self.logged = []

    def log(self, metrics, step=None):
        self.logged.append((step, dict(metrics)))


@pytest.mark.parametrize("strategy,save", [("steps", "best"), ("epoch", "best"), ("epoch", "epoch"), ("no", "no")])
def test_wandb_run_logs_match_jax(tmp_path, strategy, save):
    """The port's trainer and JAX's, each with one stub run, two epochs of three steps
    (``logging_steps=2``): the same keys at the same steps, fused path (save best/no) or
    the per-epoch loop (save epoch); values within rtol 2e-3 (rates within 1e-6)."""
    decoder, tree = _port_decoder()
    train = [{"context": c, "horizon": h, "text_embeddings": t, "metadata": {}}
             for c, h, t in zip(*_data(20, 1).values())]
    val = [{"context": c, "horizon": h, "text_embeddings": t, "metadata": {}}
           for c, h, t in zip(*_data(12, 2).values())]
    common = dict(per_device_train_batch_size=8, per_device_eval_batch_size=8, num_train_epochs=2,
                  learning_rate=1e-2, weight_decay=0.01, lr_scheduler_type="linear", warmup_steps=2,
                  eval_strategy="epoch", save_strategy=save, logging_strategy=strategy, logging_steps=2, seed=5)
    ours, ref = _Run(), _Run()
    trainer = MultimodalTrainer(decoder, TrainingArguments(output_dir=str(tmp_path / "p"), **common), train, val,
                                "multimodal", device="cpu", wandb_run=ours)
    trainer.train()
    jdec = JDecoder(JAdapter(JConfig.tiny()), JDecoderConfig(text_embedding_dims=TEXT))
    jtrainer = JTrainer(jdec, jax.tree.map(jnp.asarray, tree), JArgs(output_dir=str(tmp_path / "j"), **common),
                        JPreprocessedDataset(train, "multimodal"), JPreprocessedDataset(val, "multimodal"),
                        "multimodal", wandb_run=ref)
    jtrainer.train()
    assert [(s, sorted(m)) for s, m in ours.logged] == [(s, sorted(m)) for s, m in ref.logged]
    assert ours.logged
    for (_, a), (_, b) in zip(ours.logged, ref.logged):
        for key in a:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6 if key == "train/lr" else LOSS_RTOL, err_msg=key)
