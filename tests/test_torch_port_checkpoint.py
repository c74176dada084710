"""PyTorch port vs the JAX package: checkpoints the JAX trainer writes, and the port's backends.

The JAX trainer writes real checkpoints (the multimodal optax chain, the
fused stepper, and baseline mode with bf16 Adam moments); the port's
restricted unpickler loads them without optax, JAX or ml_dtypes, and a port
trainer resumed from one runs its next epoch as a JAX trainer resumed from
the same file does, to the tolerances of ``tests/test_torch_port_train.py``
(losses rtol 2e-3, trained parameters atol 5e-4). The same holds for the
directories the JAX trainer writes with ``ckpt_backend="orbax"``, read with
tensorstore.
"""

import fractions
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.training import checkpoint as jcheckpoint
from multimodal_timesfm_tpu.training.trainer import MultimodalTrainer as JTrainer
from multimodal_timesfm_tpu.training_args import TrainingArguments as JArgs
from multimodal_timesfm_torch.models.bridge import export_jax_params
from multimodal_timesfm_torch.training import checkpoint as tcheckpoint
from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
from multimodal_timesfm_torch.training_args import TrainingArguments
from tests.test_torch_port_train import _decoder_pair, _leaves, _samples, _train_kwargs

CASES = {
    "multimodal chain": ("multimodal", {}, {}),
    "multimodal fused": ("multimodal", {}, {"fused_optimizer": True}),
    "baseline bf16 moments": ("baseline", {"adam_moment_dtype": "bfloat16"}, {}),
}


def _jax_checkpoint(tmp_path, case, backend="pickle"):
    """(path of the epoch-0 checkpoint a JAX trainer wrote with ``backend``, the JAX trainer
    resumed from it, the port trainer)."""
    mode, args_over, knobs = CASES[case]
    train, val = _samples(12, 1, 32), _samples(4, 2, 32)
    kw = _train_kwargs(num_train_epochs=2, save_strategy="epoch", **args_over)
    _, jdec, tree = _decoder_pair(seed=6)
    writer = JTrainer(jdec, jax.tree.map(jnp.asarray, tree), JArgs(output_dir=str(tmp_path / "w"), **kw),
                      train, val, mode, fuse_epochs=False, ckpt_backend=backend, **knobs)
    writer.train_epoch()
    writer.save_ckpt(writer.validate_epoch())
    path = writer.args.checkpoint_dir / "checkpoint_epoch_0.ckpt"
    resumed = JTrainer(jdec, jax.tree.map(jnp.asarray, tree), JArgs(output_dir=str(tmp_path / "j"), **kw),
                       train, val, mode, fuse_epochs=False, ckpt_backend=backend, **knobs)
    resumed.resume_from_checkpoint(path)
    port, _, _ = _decoder_pair(seed=6)
    trainer = MultimodalTrainer(port, TrainingArguments(output_dir=str(tmp_path / "p"), **kw),
                                train, val, mode, device="cpu", **knobs)
    return path, resumed, trainer


def _resume_and_compare(path, jt, pt):
    """Resume the port trainer from ``path`` and run its next epoch against the JAX trainer
    resumed from the same checkpoint: losses rtol 2e-3, trained parameters atol 5e-4."""
    pt.resume_from_checkpoint(path)
    assert (pt.start_epoch, pt.global_step, pt.optimizer.count) == (jt.start_epoch, jt.global_step, 2)
    assert pt.best_val_loss == jt.best_val_loss
    ours = (pt.train_epoch(), pt.validate_epoch())
    ref = (jt.train_epoch(), jt.validate_epoch())
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    mine = _leaves(export_jax_params(pt.trainable_module))
    theirs = _leaves(jax.device_get(jt.state.trainable))
    assert mine.keys() == theirs.keys()
    for name in theirs:
        np.testing.assert_allclose(mine[name], np.asarray(theirs[name], np.float32), atol=5e-4, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_port_resumes_a_jax_orbax_checkpoint_as_jax_does(tmp_path, case):
    """A directory JAX's orbax backend wrote: read with tensorstore, the optimizer state
    rebuilt against JAX's (fused: the port's dict; chain: the tuple of optax states), and
    the next epoch as a JAX trainer resumed from the same directory runs it."""
    path, jt, pt = _jax_checkpoint(tmp_path, case, backend="orbax")
    assert path.is_dir() and (path / "_METADATA").exists()
    state = tcheckpoint.load_checkpoint(path)["optimizer_state"]
    if case == "multimodal fused":
        assert isinstance(state, dict) and set(state) == {"count", "mu", "nu"}
    else:
        assert isinstance(state, list)
        args = pt.args
        template = tcheckpoint.jax_optimizer_state(False, args.max_grad_norm > 0,
                                                   args.adam_moment_dtype == "bfloat16")
        rebuilt = tcheckpoint.restructure_like(template, state)
        with open(_jax_checkpoint(tmp_path / "pickled", case)[0], "rb") as f:
            pickled = tcheckpoint._RestrictedUnpickler(f).load()["optimizer_state"]
        types = lambda node: [type(x).__name__ for x in node]  # noqa: E731
        assert types(rebuilt) == types(pickled), (types(rebuilt), types(pickled))
    _resume_and_compare(path, jt, pt)
    if "bf16" in case:
        assert pt.optimizer.mu[0].dtype == torch.bfloat16


@pytest.mark.parametrize("case", list(CASES))
def test_port_resumes_a_jax_checkpoint_as_jax_does(tmp_path, case):
    path, jt, pt = _jax_checkpoint(tmp_path, case)
    payload = tcheckpoint.load_checkpoint(path)
    state = payload["optimizer_state"]
    if case == "multimodal fused":
        assert isinstance(state, tcheckpoint.ScaleByAdamState)
    else:
        assert isinstance(state, tuple) and any(isinstance(s, tcheckpoint.EmptyState) for s in state)
    count, mu, _ = tcheckpoint.adam_state(state)
    assert count == 2
    leaf = mu["tokenizer"]["hidden"]["kernel"] if "baseline" in case else mu["layers"][0]["kernel"]
    assert (leaf.dtype == torch.bfloat16) if "bf16" in case else (leaf.dtype == np.float32)
    pt.resume_from_checkpoint(path)
    assert (pt.start_epoch, pt.global_step, pt.optimizer.count) == (jt.start_epoch, jt.global_step, 2)
    assert pt.best_val_loss == jt.best_val_loss
    if "bf16" in case:
        assert pt.optimizer.mu[0].dtype == torch.bfloat16
    ours = (pt.train_epoch(), pt.validate_epoch())
    ref = (jt.train_epoch(), jt.validate_epoch())
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    mine = _leaves(export_jax_params(pt.trainable_module))
    theirs = _leaves(jax.device_get(jt.state.trainable))
    assert mine.keys() == theirs.keys()
    for name in theirs:
        np.testing.assert_allclose(mine[name], np.asarray(theirs[name], np.float32), atol=5e-4, err_msg=name)


def test_bf16_moments_come_back_as_their_bits(tmp_path):
    """The JAX trainer's bf16 moments load as torch.bfloat16 holding the same 2-byte values
    (ml_dtypes is not needed to read them)."""
    path, _, _ = _jax_checkpoint(tmp_path, "baseline bf16 moments")
    with open(path, "rb") as f:
        real = pickle.load(f)  # with optax and ml_dtypes, as JAX reads it
    ours = tcheckpoint.load_checkpoint(path)
    ref_mu = _leaves(real["optimizer_state"][1].mu)
    _, mu, _ = tcheckpoint.adam_state(ours["optimizer_state"])
    for name, value in ref_mu.items():
        leaf = mu
        for part in name.strip("/").split("/"):
            leaf = leaf[int(part)] if isinstance(leaf, list) else leaf[part]
        assert leaf.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(leaf.float().numpy(), np.asarray(value, np.float32), err_msg=name)


class _Permuted:
    """Pickles as a numpy that keeps a permuted array's layout pickles it: numpy's
    ``_frombuffer`` with order "K", the shape in memory order and the axis order back."""

    def __init__(self, arr, axis_order):
        self.arr, self.axis_order = arr, axis_order

    def __reduce_ex__(self, protocol):
        from numpy._core import numeric

        base = np.ascontiguousarray(self.arr.transpose(np.argsort(self.axis_order)))
        return numeric._frombuffer, (pickle.PickleBuffer(base), base.dtype, base.shape, "K", self.axis_order)


def test_unpickler_reads_arrays_pickled_in_a_permuted_layout(tmp_path):
    """A stack of transposed kernels (strides neither C nor F order), as ``np.stack`` of
    ``arr.T`` leaves makes it, in the five-argument form a newer numpy writes: read back
    equal, C-contiguous; an object dtype is still refused."""
    stack = np.stack([np.arange(12, dtype=np.float32).reshape(3, 4).T + i for i in range(2)])
    assert not (stack.flags.c_contiguous or stack.flags.f_contiguous)
    path = tmp_path / "permuted.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"k": _Permuted(stack, (0, 2, 1)), "c": _Permuted(np.arange(6.0).reshape(2, 3), (0, 1))},
                    f, protocol=5)
    ours = tcheckpoint.load_checkpoint(path)
    np.testing.assert_array_equal(ours["k"], stack)
    assert ours["k"].flags.c_contiguous
    np.testing.assert_array_equal(ours["c"], np.arange(6.0).reshape(2, 3))
    with open(path, "wb") as f:
        pickle.dump({"o": _Permuted(np.array([None, 1], dtype=object), (0,))}, f, protocol=5)
    with pytest.raises(pickle.UnpicklingError):
        tcheckpoint.load_checkpoint(path)


class _System:
    def __reduce__(self):
        return (os.system, ("echo unpickled",))


@pytest.mark.parametrize("payload,named", [(_System(), "system"), (fractions.Fraction(1, 3), "fractions.Fraction"),
                                           (torch.zeros(2), "torch._utils")])
def test_unpickler_refuses_every_other_global(tmp_path, payload, named):
    path = tmp_path / "foreign.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"epoch": 0, "x": payload}, f)
    with pytest.raises(pickle.UnpicklingError, match=named):
        tcheckpoint.load_checkpoint(path)


def _port_trainer(out, backend, epochs=3):
    port, _, _ = _decoder_pair(seed=4)
    args = TrainingArguments(output_dir=str(out), **_train_kwargs(
        per_device_train_batch_size=4, num_train_epochs=epochs, save_strategy="epoch",
        save_total_limit=1, learning_rate=1e-2))
    return MultimodalTrainer(port, args, _samples(8, 1), _samples(4, 2), "baseline", device="cpu",
                             ckpt_backend=backend)


def test_directory_backend_round_trips_rotates_and_resumes(tmp_path):
    """ckpt_backend="orbax" writes directories (safetensors + JSON), rotation removes them,
    no temporary directory is left, and a resume from one continues exactly as a resume
    from the pickle backend's file."""
    runs = {}
    for backend in ("pickle", "orbax"):
        trainer = _port_trainer(tmp_path / backend, backend)
        trainer.train()
        names = sorted(p.name for p in trainer.args.checkpoint_dir.iterdir())
        assert names == ["best_model.ckpt", "checkpoint_epoch_2.ckpt"], names
        assert (trainer.args.checkpoint_dir / "checkpoint_epoch_2.ckpt").is_dir() == (backend == "orbax")
        runs[backend] = trainer
    a = tcheckpoint.load_checkpoint(runs["pickle"].args.checkpoint_dir / "checkpoint_epoch_2.ckpt")
    b = tcheckpoint.load_checkpoint(runs["orbax"].args.checkpoint_dir / "checkpoint_epoch_2.ckpt")
    assert a.keys() == b.keys()
    assert (a["epoch"], a["global_step"], a["optimizer_is_fused"], a["best_val_loss"]) == (
        b["epoch"], b["global_step"], b["optimizer_is_fused"], b["best_val_loss"])
    left, right = _leaves({k: a[k] for k in ("adapter_params", "optimizer_state")}), _leaves(
        {k: b[k] for k in ("adapter_params", "optimizer_state")})
    assert left.keys() == right.keys()
    for name in left:
        np.testing.assert_array_equal(left[name], right[name], err_msg=name)

    finals = []
    for backend in ("pickle", "orbax"):
        first = _port_trainer(tmp_path / f"part_{backend}", backend, epochs=4)
        first.train_epoch()
        first.current_epoch = 0
        first.save_ckpt(first.validate_epoch())
        resumed = _port_trainer(tmp_path / f"part_{backend}", backend, epochs=2)
        resumed.resume_from_checkpoint(first.args.checkpoint_dir / "checkpoint_epoch_0.ckpt")
        resumed.train_epoch()
        finals.append(_leaves(export_jax_params(resumed.trainable_module)))
        assert not list(first.args.checkpoint_dir.glob("*tmp*"))
    for name in finals[0]:
        np.testing.assert_array_equal(finals[0][name], finals[1][name], err_msg=name)


def test_rotation_removes_directories_and_files(tmp_path):
    for i, backend in enumerate(("orbax", "pickle", "orbax")):
        tcheckpoint.save_checkpoint(tmp_path / f"checkpoint_epoch_{i}.ckpt", {"epoch": i, "w": np.ones(2, np.float32)},
                                    backend=backend)
    tcheckpoint.rotate_checkpoints(tmp_path, 1)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoint_epoch_2.ckpt"]
    assert tcheckpoint.load_checkpoint(tmp_path / "checkpoint_epoch_2.ckpt")["epoch"] == 2


def test_a_jax_orbax_directory_is_refused_by_name(tmp_path, monkeypatch):
    """Where tensorstore does not import, a JAX orbax directory is refused, naming both."""
    jcheckpoint.save_checkpoint(tmp_path / "best_model.ckpt", {"epoch": 0, "w": np.ones(2, np.float32)},
                                backend="orbax")
    assert (tmp_path / "best_model.ckpt").is_dir()
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ValueError, match="orbax checkpoint directory.*tensorstore"):
        tcheckpoint.load_checkpoint(tmp_path / "best_model.ckpt")


def test_a_jax_orbax_directory_reads_as_jax_restores_it(tmp_path):
    """Every leaf of a JAX orbax payload (arrays of several dtypes, bf16 as its 2-byte data,
    Python scalars, None, nested lists) as orbax itself restores it without a target."""
    import ml_dtypes

    payload = {
        "epoch": 3, "best_val_loss": 0.25, "optimizer_is_fused": False, "note": None,
        "fusion_params": {"layers": [{"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
                                     {"kernel": np.full((3, 2), -1.5, np.float32)}]},
        "moments": [np.linspace(-2, 2, 7).astype(ml_dtypes.bfloat16), np.arange(4, dtype=np.int32)],
    }
    jcheckpoint.save_checkpoint(tmp_path / "ck", payload, backend="orbax")
    theirs = jcheckpoint.load_checkpoint(tmp_path / "ck")
    ours = tcheckpoint.load_checkpoint(tmp_path / "ck")
    assert jax.tree.structure(ours, is_leaf=lambda x: isinstance(x, torch.Tensor)) == jax.tree.structure(theirs)
    assert (ours["epoch"], ours["best_val_loss"], ours["optimizer_is_fused"], ours["note"]) == (3, 0.25, False, None)
    bf16 = ours["moments"][0]
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.view(torch.int16).numpy(), theirs["moments"][0].view(np.int16))
    for name, mine in _leaves({k: ours[k] for k in ("fusion_params",)}).items():
        theirs_leaf = _leaves({"fusion_params": theirs["fusion_params"]})[name]
        assert mine.dtype == theirs_leaf.dtype
        np.testing.assert_array_equal(mine, theirs_leaf, err_msg=name)
    np.testing.assert_array_equal(ours["moments"][1], theirs["moments"][1])
