"""The parallel slice: the port's (data, model) mesh against JAX's and against no mesh.

Two gloo processes on the CPU (``tests/test_torch_port_parallel_worker.py``,
spawned once for the module) run the port's trainer, evaluator, Forecaster and
vectorized trials over a (2, 1) and a (1, 2) mesh on tiny TimesFM-2.5 and
Chronos-2 decoders, while this process runs the JAX package on the same weights
(numpy trees drawn by ``models/bridge.random_jax_params``) and the same data,
on meshes of its 8 virtual CPU devices (``tests/conftest.py``), and the port
without a mesh. Tolerances are stated beside each test; those of JAX's own
sharding tests (``tests/test_sharding.py:96-101``) where they apply.
"""

from __future__ import annotations

import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from multimodal_timesfm_tpu.models.chronos import Chronos2Adapter as JChronos
from multimodal_timesfm_tpu.models.chronos import Chronos2Config as JChronosConfig
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoder as JDecoder
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoderConfig as JDecoderConfig
from multimodal_timesfm_tpu.models.timesfm import TimesFM2p5Adapter as JTimesFM
from multimodal_timesfm_tpu.models.timesfm import TimesFMConfig as JTimesFMConfig
from multimodal_timesfm_tpu.parallel.mesh import MeshConfig as JMeshConfig
from multimodal_timesfm_tpu.parallel.mesh import make_mesh as j_make_mesh
from multimodal_timesfm_tpu.parallel.sharding import param_specs as j_param_specs
from multimodal_timesfm_tpu.parallel.sharding import shard_params as j_shard_params
from multimodal_timesfm_tpu.training.trainer import MultimodalTrainer as JTrainer
from multimodal_timesfm_tpu.training_args import TrainingArguments as JArgs
from multimodal_timesfm_torch import parallel
from multimodal_timesfm_torch.inference import Forecaster
from multimodal_timesfm_torch.models.bridge import _jax_path, export_jax_params, random_jax_params
from multimodal_timesfm_torch.models.layers import dense
from multimodal_timesfm_torch.parallel.sharding import check_divisible, param_specs
from multimodal_timesfm_torch.training import vectorized as tvec
from multimodal_timesfm_torch.training.checkpoint import load_checkpoint
from multimodal_timesfm_torch.training.evaluator import MultimodalEvaluator
from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
from tests import test_torch_port_parallel_worker as worker

JMODELS = {
    "timesfm": lambda: JDecoder(JTimesFM(JTimesFMConfig.tiny()), JDecoderConfig(text_embedding_dims=worker.TEXT)),
    "chronos": lambda: JDecoder(JChronos(JChronosConfig.tiny()), JDecoderConfig(text_embedding_dims=worker.TEXT)),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_args(out, **over) -> JArgs:
    kw = dict(
        output_dir=str(out), per_device_train_batch_size=8, per_device_eval_batch_size=4, num_train_epochs=1,
        learning_rate=1e-2, eval_strategy="epoch", save_strategy="no", logging_strategy="no", seed=0,
    )
    kw.update(over)
    return JArgs(**kw)


def _jax_cell(cell: str, tree: dict, out, mesh=None, shard=None) -> dict:
    kind, mode, _, seed = worker.CELLS[cell]
    train, val = worker.cell_data(cell)
    trainer = JTrainer(JMODELS[kind](), jax.tree.map(jnp.asarray, tree), _jax_args(out, seed=seed), train, val,
                       mode, mesh=mesh, shard_params_fn=shard, fuse_epochs=False)
    loss = trainer.train_epoch()
    return {"loss": loss, "val": trainer.validate_epoch(),
            "params": worker._leaves(jax.device_get(trainer.state.trainable))}


def _port_cell(cell: str, tree: dict, out) -> dict:
    kind, mode, _, seed = worker.CELLS[cell]
    train, val = worker.cell_data(cell)
    trainer = MultimodalTrainer(worker.decoder(kind, tree), worker.train_args(out, seed=seed), train, val, mode,
                                device="cpu")
    loss = trainer.train_epoch()
    return {"loss": loss, "val": trainer.validate_epoch(),
            "params": worker._leaves(export_jax_params(trainer.trainable_module))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' readings, JAX's and the port's without a mesh, on the same trees."""
    tmp = tmp_path_factory.mktemp("parallel")
    trees = {kind: random_jax_params(worker.decoder(kind), seed) for seed, kind in enumerate(("timesfm", "chronos"))}
    # A checkpoint the JAX trainer wrote (its optax chain), for the ranks to resume from.
    train, val = worker.cell_data("mp2_timesfm_base")
    jt = JTrainer(JMODELS["timesfm"](), jax.tree.map(jnp.asarray, trees["timesfm"]),
                  _jax_args(tmp / "jax_ckpt", seed=7, save_strategy="epoch", num_train_epochs=2), train, val,
                  "baseline", fuse_epochs=False)
    jt.train_epoch()
    jt.save_ckpt(jt.validate_epoch())
    trees["jax_ckpt"] = str(jt.args.checkpoint_dir / "checkpoint_epoch_0.ckpt")

    ranks = mp.start_processes(worker.run, args=(2, _free_port(), trees, str(tmp)), nprocs=2, join=False,
                               start_method="spawn")
    # Meanwhile: JAX on its 8 virtual devices, and the port without a mesh.
    devices = jax.devices()
    mp2 = j_make_mesh(JMeshConfig(data_parallel=1, model_parallel=2), devices[:2])
    jax_runs = {
        "dp2_timesfm_mm": _jax_cell("dp2_timesfm_mm", trees["timesfm"], tmp / "j0",
                                    j_make_mesh(JMeshConfig(data_parallel=8, model_parallel=1))),
        "mp2_timesfm_base": _jax_cell("mp2_timesfm_base", trees["timesfm"], tmp / "j1", mp2, j_shard_params),
        "mp2_chronos_base": _jax_cell("mp2_chronos_base", trees["chronos"], tmp / "j2", mp2, j_shard_params),
    }
    port_runs = {cell: _port_cell(cell, trees[worker.CELLS[cell][0]], tmp / f"p_{cell}") for cell in worker.CELLS}
    while not ranks.join():
        pass
    seen = []
    for rank in range(2):
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            seen.append(pickle.load(f))
    return {"trees": trees, "seen": seen, "jax": jax_runs, "port": port_runs, "tmp": tmp}


# ---------------------------------------------------------------------------
# the mesh's shape arithmetic and its errors, without a process group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "config,n,shape",
    [(None, 8, (8, 1)), (parallel.MeshConfig(model_parallel=2), 8, (4, 2)),
     (parallel.MeshConfig(data_parallel=2, model_parallel=4), 8, (2, 4)), (None, 1, (1, 1))],
)
def test_mesh_shapes(config, n, shape):
    """The shapes of ``tests/test_utils.py:22-33`` (JAX's ``make_mesh`` over 8 devices)."""
    assert parallel.mesh_shape(config, n) == shape


@pytest.mark.parametrize(
    "config,match",
    [(parallel.MeshConfig(data_parallel=3, model_parallel=3), "does not match 8 devices"),
     (parallel.MeshConfig(model_parallel=0), "model_parallel must be >= 1"),
     (parallel.MeshConfig(model_parallel=16), "does not match 8 devices")],
)
def test_mesh_shape_errors(config, match):
    """JAX's errors, word for word."""
    with pytest.raises(ValueError, match=match):
        parallel.mesh_shape(config, 8)


def test_make_mesh_needs_a_process_group_and_pad_to_multiple():
    """No process group: ``make_mesh`` and every entry point given a mesh raise; the padding
    and the row split of ``parallel.mesh`` are plain arithmetic."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="make_mesh needs an initialised process group"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="MultimodalEvaluator with a mesh needs an initialised process group"):
        MultimodalEvaluator(worker.decoder("timesfm"), device="cpu", mesh=object())
    assert [parallel.pad_to_multiple(n, 4) for n in (1, 4, 5, 8, 9)] == [4, 4, 8, 8, 12]
    rows = np.arange(6)
    assert parallel.local_rows(rows, None) is rows


@pytest.mark.parametrize("kind", ["timesfm", "chronos"])
def test_param_specs_match_jax(kind):
    """For every JAX leaf, the port's parameter (named through ``models/bridge.py``) is
    sharded on the torch dim that holds JAX's sharded dim, or replicated as JAX keeps it
    (``tests/test_sharding.py:23-60``): a kernel's last dim (out) is torch dim 0, its
    second-last (in) torch dim 1, a bias's last dim torch dim 0."""
    port = worker.decoder(kind)
    specs = param_specs(port)
    jdec = JMODELS[kind]()
    jspecs = j_param_specs(jdec.init(jax.random.key(0)))
    flat = {}
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for path, spec in jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=is_spec)[0]:
        key = "/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)
        flat[key] = spec
    shapes = dict(port.named_parameters())
    sharded, paths = 0, set()
    for name, dim in specs.items():
        path = _jax_path(name[: -len("weight")] + "kernel" if name.endswith("weight") else name)[0]
        paths.add(path)
        jspec = tuple(flat[path])
        model_dims = [i - len(jspec) for i, axis in enumerate(jspec) if axis == "model"]
        if dim is None:
            assert not model_dims, (name, jspec)
            continue
        sharded += 1
        ndim = shapes[name].dim()
        want = {(2, -1): 0, (2, -2): 1, (1, -1): 0}[(ndim, model_dims[0])]
        assert dim == want, (name, jspec, dim)
    assert sharded > 0
    assert paths == set(flat)


def test_uneven_shards_are_refused_by_name():
    """Where GSPMD pads, the port raises naming the parameter, or the heads."""
    with pytest.raises(ValueError, match=r"adapter\.tokenizer\.hidden\.weight: dim 0 of size 32 does not divide"):
        check_divisible(worker.decoder("timesfm"), 3)
    check_divisible(worker.decoder("timesfm"), 4)
    with pytest.raises(ValueError, match="2 attention heads do not divide over the model axis of 4"):
        check_divisible(worker.decoder("chronos", model_dim=64, ffn_dim=64), 4)


# ---------------------------------------------------------------------------
# two ranks against JAX and against no mesh
# ---------------------------------------------------------------------------


def test_ranks_saw_their_meshes(runs):
    """(dp, mp, data rank, model rank): model groups are adjacent ranks."""
    assert [s["mesh"] for s in runs["seen"]] == [
        {"dp2": (2, 1, 0, 0), "mp2": (1, 2, 0, 0)}, {"dp2": (2, 1, 1, 0), "mp2": (1, 2, 0, 1)},
    ]


def test_data_parallel_epoch_matches_jax_and_one_process(runs):
    """dp = 2, multimodal TimesFM tiny, one epoch of 24 series in batches of 8: the
    loss within 1e-5 of JAX's on an 8-device mesh (``tests/distributed_worker.py``'s
    geometry) and of the port in one process; validation 1e-4, parameters 5e-3
    (``tests/test_sharding.py``'s). Both ranks report the same numbers."""
    cell = "dp2_timesfm_mm"
    ours = runs["seen"][0][cell]
    assert runs["seen"][1][cell]["loss"] == ours["loss"] and runs["seen"][1][cell]["val"] == ours["val"]
    for ref in (runs["jax"][cell], runs["port"][cell]):
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(ours["val"], ref["val"], atol=1e-4)
        for name, value in ref["params"].items():
            np.testing.assert_allclose(ours["params"][name], value, atol=5e-3, err_msg=name)


@pytest.mark.parametrize("cell", ["mp2_timesfm_base", "mp2_chronos_base"])
def test_tensor_parallel_epoch_matches_jax(runs, cell):
    """mp = 2, baseline, one epoch: validation within 1e-4 of JAX's ``shard_params`` run on
    a (1, 2) mesh and the gathered parameters within 5e-3 (``tests/test_sharding.py:64-148``);
    the same against the port without a mesh. Each rank holds half of each sharded tensor."""
    ours = runs["seen"][0][cell]
    for ref in (runs["jax"][cell], runs["port"][cell]):
        np.testing.assert_allclose(ours["val"], ref["val"], atol=1e-4)
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-4)
        assert ours["params"].keys() == ref["params"].keys()
        for name, value in ref["params"].items():
            np.testing.assert_allclose(ours["params"][name], value, atol=5e-3, err_msg=name)
    whole = dict(worker.decoder(worker.CELLS[cell][0]).adapter.named_parameters())
    specs = param_specs(worker.decoder(worker.CELLS[cell][0]).adapter)
    for seen in runs["seen"]:
        for name, dim in specs.items():
            want = list(whole[name].shape)
            if dim is not None:
                want[dim] //= 2
            assert list(seen[cell]["local_shapes"][name]) == want, name


def test_checkpoint_under_mp2_loads_whole_without_a_mesh(runs):
    """The best checkpoint written under mp = 2 holds whole arrays, bit-equal to the
    gathered weights, and loads into a decoder without a mesh."""
    for cell in ("mp2_timesfm_base", "mp2_chronos_base"):
        seen = runs["seen"][0][cell]
        ckpt = load_checkpoint(seen["ckpt"])
        tree = worker._leaves(ckpt["adapter_params"])
        assert tree.keys() == seen["params"].keys()
        for name, value in seen["params"].items():
            np.testing.assert_array_equal(tree[name], value, err_msg=name)
        kind = worker.CELLS[cell][0]
        whole = worker.decoder(kind)
        from multimodal_timesfm_torch.models.bridge import load_jax_params

        load_jax_params(whole.adapter, ckpt["adapter_params"])
        assert ckpt["optimizer_state"]["count"] == 3


def test_jax_pickle_resumes_under_mp2(runs, tmp_path):
    """The JAX trainer's pickle (optax chain, whole arrays) resumed under mp = 2 and trained
    one more epoch: the loss and validation of the port resumed without a mesh, 1e-5 and
    1e-4."""
    train, val = worker.cell_data("mp2_timesfm_base")
    one = MultimodalTrainer(worker.decoder("timesfm", runs["trees"]["timesfm"]),
                            worker.train_args(tmp_path, seed=7, num_train_epochs=2), train, val, "baseline",
                            device="cpu")
    one.resume_from_checkpoint(runs["trees"]["jax_ckpt"])
    ref_loss, ref_val = one.train_epoch(), one.validate_epoch()
    for seen in runs["seen"]:
        np.testing.assert_allclose(seen["resumed"]["loss"], ref_loss, rtol=1e-5)
        np.testing.assert_allclose(seen["resumed"]["val"], ref_val, atol=1e-4)
        assert seen["resumed"]["count"] == one.optimizer.count == 6


def test_fused_path_at_dp2_matches_one_process(runs, tmp_path):
    """``train_epochs_fused`` at dp = 2 (eager on the CPU) against one process: every
    micro-batch loss 1e-5, validation 1e-4."""
    kind, mode, _, seed = worker.CELLS["dp2_timesfm_mm"]
    train, val = worker.cell_data("dp2_timesfm_mm")
    one = MultimodalTrainer(worker.decoder(kind, runs["trees"][kind]),
                            worker.train_args(tmp_path, seed=seed, num_train_epochs=2), train, val, mode,
                            device="cpu")
    losses, vals = one.train_epochs_fused(2)
    ours = runs["seen"][0]["dp2_timesfm_mm"]["fused"]
    np.testing.assert_allclose(ours[0], losses, rtol=1e-5)
    np.testing.assert_allclose(ours[1], vals, atol=1e-4)


def test_folds_stay_off_under_shard_params(runs, tmp_path):
    """One patch token, multimodal: without tensor parallelism both folds apply, with
    ``shard_params_fn`` neither (JAX ``trainer.py:234,251``)."""
    short = worker.samples(8, 4, context=4)
    plain = MultimodalTrainer(worker.decoder("timesfm", runs["trees"]["timesfm"]), worker.train_args(tmp_path),
                              short, short, "multimodal", device="cpu")
    assert (plain.folded_seq1, plain._folded_affine) == (True, True)
    assert [s["folds"] for s in runs["seen"]] == [(False, False), (False, False)]


@pytest.mark.parametrize("kind", ["timesfm", "chronos"])
def test_gradient_collectives_give_the_unsharded_gradient(runs, kind):
    """mp = 2: the gradient of each replicated tensor upstream of a sharded GEMM equals the
    unsharded one to 5e-6 of its largest element (fp32): TimesFM's qkv and attn_norm,
    upstream of the row-parallel ``attn.out``, Chronos's ``rel_pos_bias``, cut to each
    rank's heads, and its attn_norm. They get their whole gradient only through the
    all-reduce of the copy into the model axis: without it they would be half of it. The
    sums in another order leave up to 2.4e-6 (Chronos's attn_norm), so 1e-6 would fail
    on rounding alone. Every other gradient, gathered whole, to 1e-5 of its largest
    element (through the sharded GEMMs)."""
    dec = worker.decoder(kind, runs["trees"][kind])
    ref = worker.input_grads(dec)
    for seen in runs["seen"]:
        ours = seen["grads"][kind]
        assert ours.keys() == ref.keys()
        for name, value in ref.items():
            atol = (5e-6 if name in worker.GRAD_NAMES[kind] else 1e-5) * np.abs(value).max()
            np.testing.assert_allclose(ours[name], value, rtol=0, atol=atol, err_msg=name)
        for name in worker.GRAD_NAMES[kind]:
            assert np.abs(ref[name]).max() > 0, name


def test_bf16_row_parallel_dense_keeps_the_bf16_gemm(runs):
    """mp = 2, a bf16-stored row-parallel Dense under bf16 compute: each rank's bf16 GEMM
    with an fp32 result, the fp32 partials summed over the model axis, the bias added once,
    one cast. Its output and the gradients of x, the weight and the bias, all bf16, within
    one bf16 rounding (2^-8 relative) of the unsharded ``dense`` on the same bf16 tensors;
    only the fp32 summation order differs."""
    x, weight, bias, cot = worker.bf16_dense_inputs()
    x, weight, bias = (t.clone().requires_grad_(True) for t in (x, weight, bias))
    y = dense(x, weight, bias)
    grads = torch.autograd.grad((y.float() * cot.float()).sum(), [x, weight, bias])
    ref = {"y": y.detach(), "dx": grads[0], "dw": grads[1], "db": grads[2]}
    for seen in runs["seen"]:
        ours = seen["bf16_row_dense"]
        for name, want in ref.items():
            assert ours[name].dtype == torch.bfloat16, name
            np.testing.assert_allclose(ours[name].float().numpy(), want.float().numpy(), rtol=2**-8,
                                       atol=2**-8 * want.float().abs().max().item(), err_msg=name)


def test_forecaster_and_evaluator_at_dp2_match_no_mesh(runs):
    """Forecasts (point, denormalised; all channels; the autoregressive decode) at dp = 2 and
    Chronos-2's at mp = 2 on every rank, within 1e-5 x std of the same without a mesh; the
    evaluator's metrics within 1e-5."""
    data = worker.samples(10, 5)
    ctx = np.stack([s["context"] for s in data])
    text = np.stack([s["text_embeddings"] for s in data])
    fc = Forecaster(worker.decoder("timesfm", runs["trees"]["timesfm"]), batch_size=4, device="cpu")
    fc_c = Forecaster(worker.decoder("chronos", runs["trees"]["chronos"]), batch_size=4, device="cpu")
    ref = {
        "dp2": fc.forecast_dataset(worker.HORIZON, data, denormalize=True),
        "dp2_full": fc.forecast(worker.HORIZON, ctx, text_embeddings=text, full=True),
        "dp2_ar": fc.forecast_autoregressive(20, ctx),
        "mp2_chronos": fc_c.forecast_dataset(worker.HORIZON, data),
    }
    evaluator = MultimodalEvaluator(worker.decoder("timesfm", runs["trees"]["timesfm"]), device="cpu")
    ref_eval = [dict(evaluator.evaluate(data, batch_size=4, quantile_metrics=q)) for q in (False, True)]
    for seen in runs["seen"]:
        for key, value in ref.items():
            assert seen["forecast"][key].shape == value.shape, key
            np.testing.assert_allclose(seen["forecast"][key], value, rtol=0, atol=1e-5 * value.std(), err_msg=key)
        for ours, want in zip(seen["evaluate"], ref_eval):
            assert ours.keys() == want.keys()
            for name in want:
                np.testing.assert_allclose(ours[name], want[name], rtol=1e-5, err_msg=name)


def test_vectorized_trials_at_dp2_match_no_mesh(runs):
    """T = 4 distinct trials at dp = 2 (two a rank, their own learning rates and batch
    orders) against the same four on one process: losses, best validation and the test
    MSE/MAE of ``evaluate_vectorized`` within 1e-5; each rank kept its block of two."""
    dec = worker.decoder("timesfm", runs["trees"]["timesfm"])
    init = {k: v.detach().clone() for k, v in dec.fusion.named_parameters()}
    res = tvec.run_vectorized_trials(dec, tvec.replicate_trainables(init, 4), worker.trial_data(20, 6),
                                     worker.trial_data(8, 7), worker.TRIAL_HP, **worker.TRIAL_KW)
    mse, mae = tvec.evaluate_vectorized(dec, res.best_trainable, worker.trial_data(9, 8),
                                        horizon_len=worker.HORIZON, batch_size=4)
    for seen in runs["seen"]:
        trials = seen["trials"]
        for key, value in (("train", res.train_losses), ("val", res.val_losses), ("best", res.best_val),
                           ("mse", mse), ("mae", mae)):
            np.testing.assert_allclose(trials[key], value, rtol=1e-5, err_msg=key)
        assert set(trials["block"].values()) == {2}
    assert len(set(np.round(res.best_val, 6))) == 4  # the trials differ


def test_mesh_validation_errors(runs):
    """JAX's errors for a batch or a trial count that the data axis does not divide, and the
    port's for a dim that the model axis does not divide (GSPMD would pad it)."""
    for seen in runs["seen"]:
        errors = seen["errors"]
        assert "batch_size (3) must be divisible by the mesh data axis (2)" in errors["forecast_batch"]
        assert "trial count (3) must be divisible by the mesh data axis (2)" in errors["trial_count"]
        assert "adapter.stacked_xf.layers.0.ffn_up.weight: dim 0 of size 31" in errors["uneven_shard"]
