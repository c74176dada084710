"""Worker of tests/test_torch_port_parallel.py: the port on two gloo ranks of the CPU.

Holds no test. Each of the two spawned ranks joins the process group through
``parallel.initialize_multihost``, builds a (2, 1) and a (1, 2) mesh, runs every
scenario on them (the weights are the numpy trees the test drew, the data comes
from the seeds below) and pickles what it saw to ``rank<r>.pkl``; the test holds
those values against JAX and against the port without a mesh. Nothing here
imports JAX.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

CONTEXT, HORIZON, TEXT = 16, 8, 6


def samples(n: int, seed: int, context: int = CONTEXT) -> list[dict]:
    """Series with text embeddings (one row per patch of 4), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [
        {
            "context": (rng.normal(size=context) + np.sin(np.arange(context))).astype(np.float32),
            "horizon": rng.normal(size=HORIZON).astype(np.float32),
            "text_embeddings": rng.normal(size=(context // 4, TEXT)).astype(np.float32),
            "metadata": {"mean": 1.0, "std": 2.0},
        }
        for _ in range(n)
    ]


def trial_data(n: int, seed: int) -> dict[str, np.ndarray]:
    stacked = samples(n, seed)
    return {
        "context": np.stack([s["context"] for s in stacked]),
        "horizon": np.stack([s["horizon"] for s in stacked]),
        "text": np.stack([s["text_embeddings"] for s in stacked]),
    }


TRIAL_HP = {
    "learning_rate": np.asarray([1e-2, 5e-3, 2e-3, 1e-3], np.float32),
    "weight_decay": np.asarray([0.0, 0.01, 0.02, 0.0], np.float32),
    "warmup_steps": np.asarray([0.0, 1.0, 0.0, 2.0], np.float32),
}
TRIAL_KW = dict(horizon_len=HORIZON, batch_size=8, num_epochs=2, seed=3, seed_stride=1)


def decoder(kind: str, tree: dict | None = None, **config):
    """A tiny TimesFM or Chronos-2 decoder on the CPU, loaded from ``tree`` when given."""
    import dataclasses

    from multimodal_timesfm_torch.models.bridge import load_jax_params
    from multimodal_timesfm_torch.models.chronos import Chronos2Adapter, Chronos2Config
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig

    if kind == "timesfm":
        adapter = TimesFM2p5Adapter(dataclasses.replace(TimesFMConfig.tiny(), **config))
    else:
        adapter = Chronos2Adapter(dataclasses.replace(Chronos2Config.tiny(), **config))
    dec = MultimodalDecoder(adapter, MultimodalDecoderConfig(text_embedding_dims=TEXT), device="cpu")
    if tree is not None:
        load_jax_params(dec, tree)
    return dec


def train_args(out: Path, **over):
    from multimodal_timesfm_torch.training_args import TrainingArguments

    kw = dict(
        output_dir=str(out), per_device_train_batch_size=8, per_device_eval_batch_size=4, num_train_epochs=1,
        learning_rate=1e-2, eval_strategy="epoch", save_strategy="no", logging_strategy="no", seed=0,
    )
    kw.update(over)
    return TrainingArguments(**kw)


# (tree key, mode, samples seed, trainer seed) of the three one-epoch training cells
CELLS = {
    "dp2_timesfm_mm": ("timesfm", "multimodal", 0, 0),
    "mp2_timesfm_base": ("timesfm", "baseline", 1, 7),
    "mp2_chronos_base": ("chronos", "baseline", 2, 9),
}


def cell_data(cell: str) -> tuple[list[dict], list[dict]]:
    seed = CELLS[cell][2]
    data = samples(24, seed)
    return data, data[:8]


def grad_inputs(seed: int = 11) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(4, CONTEXT)).astype(np.float32))
    masks = torch.zeros_like(x, dtype=torch.bool)
    text = torch.from_numpy(rng.normal(size=(4, CONTEXT // 4, TEXT)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(4, HORIZON)).astype(np.float32))
    return x, masks, text, cot


GRAD_NAMES = {  # replicated, upstream of a sharded GEMM: whole gradients only through the all-reduce
    "timesfm": ("adapter.stacked_xf.layers.0.attn.qkv.weight", "adapter.stacked_xf.layers.0.attn_norm.scale",
                "adapter.stacked_xf.layers.1.attn.qkv.weight", "adapter.stacked_xf.layers.1.attn_norm.scale"),
    "chronos": ("adapter.encoder.rel_pos_bias", "adapter.encoder.layers.0.attn_norm.scale",
                "adapter.encoder.layers.1.attn_norm.scale"),
}


def input_grads(dec) -> dict[str, np.ndarray]:
    """Gradients of every parameter (whole tensors) of a fixed loss of the decoder."""
    from multimodal_timesfm_torch.parallel.sharding import gather_params

    x, masks, text, cot = grad_inputs()
    dec.requires_grad_(True)
    loss = (dec(HORIZON, x, masks, text) * cot).sum()
    params = dict(dec.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    whole = gather_params(dec, dict(zip(params.values(), grads)))
    return {name: whole[p].numpy() for name, p in params.items()}


def bf16_dense_inputs(seed: int = 12) -> tuple[torch.Tensor, ...]:
    """(x (4, 16), weight (8, 16), bias (8,), cotangent (4, 8)), all bf16: a bf16-stored
    ``ffn_down`` under bf16 compute."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
                 for shape in ((4, 16), (8, 16), (8,), (4, 8)))


def bf16_row_dense(mesh) -> dict[str, np.ndarray]:
    """A bf16 ``ffn_down`` made row-parallel by ``shard_params``, fed this rank's block of
    the input features: its output, and the gradients of x, the weight and the bias,
    each whole (x's blocks summed over the ranks, the weight's gathered)."""
    from multimodal_timesfm_torch.models.layers import Dense
    from multimodal_timesfm_torch.parallel import shard_params
    from multimodal_timesfm_torch.parallel.sharding import gather_params

    x, weight, bias, cot = bf16_dense_inputs()
    module = torch.nn.Module()
    module.ffn_down = Dense.of(weight.clone(), bias.clone())
    module.requires_grad_(True)
    shard_params(module, mesh)
    down = module.ffn_down
    x.requires_grad_(True)
    y = down(down.parallel[1].block(x, -1))
    dx, dw, db = torch.autograd.grad((y.float() * cot.float()).sum(), [x, down.weight, down.bias])
    torch.distributed.all_reduce(dx, group=down.parallel[1].group)
    whole = gather_params(module, {down.weight: dw, down.bias: db})
    return {"y": y.detach(), "dx": dx, "dw": whole[down.weight], "db": whole[down.bias]}


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


def run(rank: int, world: int, port: int, trees: dict, out_dir: str) -> None:
    """One rank: every scenario, what it saw pickled to ``out_dir/rank<rank>.pkl``."""
    torch.set_num_threads(1)
    from multimodal_timesfm_torch import parallel
    from multimodal_timesfm_torch.inference import Forecaster
    from multimodal_timesfm_torch.models.bridge import export_jax_params
    from multimodal_timesfm_torch.parallel.sharding import gather_params
    from multimodal_timesfm_torch.training import vectorized as tvec
    from multimodal_timesfm_torch.training.evaluator import MultimodalEvaluator
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer

    out = Path(out_dir)
    parallel.initialize_multihost(f"localhost:{port}", world, rank)
    dp2 = parallel.make_mesh(parallel.MeshConfig(data_parallel=2, model_parallel=1))
    mp2 = parallel.make_mesh(parallel.MeshConfig(data_parallel=1, model_parallel=2))
    seen: dict = {"mesh": {name: (m.size(0), m.size(1), m.get_local_rank("data"), m.get_local_rank("model"))
                           for name, m in (("dp2", dp2), ("mp2", mp2))}}

    # One epoch per cell (and the fused path at dp=2): losses, validation, trained params.
    for cell, (kind, mode, _, seed) in CELLS.items():
        mesh, shard = (dp2, None) if cell.startswith("dp2") else (mp2, parallel.shard_params)
        train, val = cell_data(cell)
        workdir = out / cell
        args = train_args(workdir, seed=seed, save_strategy="epoch")
        trainer = MultimodalTrainer(decoder(kind, trees[kind]), args, train, val, mode, device="cpu",
                                    mesh=mesh, shard_params_fn=shard)
        loss = trainer.train_epoch()
        val_loss = trainer.validate_epoch()
        trainer.save_ckpt(val_loss)  # checkpoints of whole arrays, written by rank 0
        module = trainer.trainable_module
        seen[cell] = {
            "loss": loss, "val": val_loss, "ckpt": str(args.checkpoint_dir / "best_model.ckpt"),
            "params": _leaves(export_jax_params(module, gather_params(module))),
            "local_shapes": {n: tuple(p.shape) for n, p in module.named_parameters()},
        }
        if cell == "dp2_timesfm_mm":
            fused = MultimodalTrainer(decoder(kind, trees[kind]),
                                      train_args(workdir / "f", seed=seed, num_train_epochs=2),
                                      train, val, mode, device="cpu", mesh=mesh)
            seen[cell]["fused"] = [a.tolist() for a in fused.train_epochs_fused(2)]

    # A JAX-written pickle resumed under the (1, 2) mesh, then one more epoch.
    train, val = cell_data("mp2_timesfm_base")
    resumed = MultimodalTrainer(decoder("timesfm", trees["timesfm"]), train_args(out / "resumed", seed=7,
                                num_train_epochs=2), train, val, "baseline", device="cpu", mesh=mp2,
                                shard_params_fn=parallel.shard_params)
    resumed.resume_from_checkpoint(trees["jax_ckpt"])
    seen["resumed"] = {"loss": resumed.train_epoch(), "val": resumed.validate_epoch(),
                       "count": resumed.optimizer.count}

    # The folds stay off under shard_params_fn (one patch token: both would fold).
    short = samples(8, 4, context=4)
    folded = MultimodalTrainer(decoder("timesfm", trees["timesfm"]), train_args(out / "folds"), short, short,
                               "multimodal", device="cpu", mesh=mp2, shard_params_fn=parallel.shard_params)
    seen["folds"] = (folded.folded_seq1, folded._folded_affine)

    # Gradients of the whole model under mp = 2, every tensor gathered whole.
    seen["grads"] = {}
    for kind in ("timesfm", "chronos"):
        seen["grads"][kind] = input_grads(parallel.shard_params(decoder(kind, trees[kind]), mp2))
    seen["bf16_row_dense"] = bf16_row_dense(mp2)

    # Serving and evaluation at dp = 2, serving at mp = 2.
    data = samples(10, 5)
    ctx = np.stack([s["context"] for s in data])
    text = np.stack([s["text_embeddings"] for s in data])
    fc = Forecaster(decoder("timesfm", trees["timesfm"]), batch_size=4, device="cpu", mesh=dp2)
    fc_mp = Forecaster(decoder("chronos", trees["chronos"]), batch_size=4, device="cpu", mesh=mp2,
                       shard_params_fn=parallel.shard_params)
    seen["forecast"] = {
        "dp2": fc.forecast_dataset(HORIZON, data, denormalize=True),
        "dp2_full": fc.forecast(HORIZON, ctx, text_embeddings=text, full=True),
        "dp2_ar": fc.forecast_autoregressive(20, ctx),
        "mp2_chronos": fc_mp.forecast_dataset(HORIZON, data),
    }
    evaluator = MultimodalEvaluator(decoder("timesfm", trees["timesfm"]), device="cpu", mesh=dp2)
    seen["evaluate"] = [dict(evaluator.evaluate(data, batch_size=3, quantile_metrics=q)) for q in (False, True)]

    # Four distinct trials at dp = 2, two a rank.
    dec = decoder("timesfm", trees["timesfm"])
    init = {k: v.detach().clone() for k, v in dec.fusion.named_parameters()}
    res = tvec.run_vectorized_trials(dec, tvec.replicate_trainables(init, 4, dp2), trial_data(20, 6),
                                     trial_data(8, 7), TRIAL_HP, mesh=dp2, **TRIAL_KW)
    mse, mae = tvec.evaluate_vectorized(dec, res.best_trainable, trial_data(9, 8), horizon_len=HORIZON,
                                        batch_size=4, mesh=dp2)
    seen["trials"] = {"train": res.train_losses, "val": res.val_losses, "best": res.best_val,
                      "mse": mse, "mae": mae, "block": {k: v.shape[0] for k, v in res.best_trainable.items()}}

    # The validation errors that need a mesh.
    errors = {}
    for name, fn in (
        ("forecast_batch", lambda: Forecaster(decoder("timesfm"), batch_size=3, device="cpu", mesh=dp2)),
        ("trial_count", lambda: tvec.run_vectorized_trials(
            dec, init, trial_data(4, 0), trial_data(4, 1), {k: v[:3] for k, v in TRIAL_HP.items()},
            mesh=dp2, **TRIAL_KW)),
        ("uneven_shard", lambda: parallel.shard_params(decoder("timesfm", ffn_dims=31), mp2)),
    ):
        try:
            fn()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    seen["errors"] = errors

    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(seen, f)
    torch.distributed.destroy_process_group()
