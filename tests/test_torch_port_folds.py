"""The frozen folds of the PyTorch port against the JAX package's.

Counterparts of ``tests/test_fold_seq1.py`` and ``tests/test_fold_affine.py``:
the port's folded stack against JAX's folded tree leaf by leaf through the
bridge, folded forward and input gradient against unfolded, the loud failure
of a one-token fold at S > 1, idempotence, Chronos-2 left unfolded, the
trainer's gates, and the folded trainer's trajectory against JAX's. Inputs
are numpy draws from a seed; the port runs on the CPU through its plain
attention path, as JAX does off the TPU. Tolerances are stated beside each
test.
"""

import copy
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodal_timesfm_tpu.models import layers as jl
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoder as JDecoder
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoderConfig as JDecoderConfig
from multimodal_timesfm_tpu.models.timesfm import TimesFM2p5Adapter as JAdapter
from multimodal_timesfm_tpu.models.timesfm import TimesFMConfig as JConfig
from multimodal_timesfm_tpu.training.trainer import MultimodalTrainer as JTrainer
from multimodal_timesfm_tpu.training_args import TrainingArguments as JArgs
from multimodal_timesfm_torch.models import layers as tl
from multimodal_timesfm_torch.models.bridge import export_jax_params, load_jax_params, random_jax_params
from multimodal_timesfm_torch.models.chronos import Chronos2Adapter, Chronos2Config
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
from multimodal_timesfm_torch.training_args import TrainingArguments

TEXT = 6
HEADS, DIM, MD, FFN = 2, 16, 32, 48


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


class _Stack(nn.Module):
    """Gives a bare stack the ``stacked_xf`` name, so the bridge stacks its leaves."""

    def __init__(self, stack):
        super().__init__()
        self.stacked_xf = stack


def _stack_pair(seed):
    """(port ``_Stack`` of 2 layers, its JAX-layout tree) with every gain, bias and
    per-dim scale drawn away from its init, so each fold moves something."""
    module = _Stack(tl.StackedTransformer(2, MD, HEADS, DIM, FFN, torch.Generator().manual_seed(0)))
    tree = random_jax_params(module, seed)
    load_jax_params(module, tree)
    return module, tree


JFOLDS = {
    "seq1": jl.fold_seq1_attention,
    "affine": jl.fold_frozen_affines,
    "seq1+affine": lambda t: jl.fold_frozen_affines(jl.fold_seq1_attention(t)),
    "affine+seq1": lambda t: jl.fold_seq1_attention(jl.fold_frozen_affines(t)),
}
TFOLDS = {
    "seq1": tl.fold_seq1_attention,
    "affine": tl.fold_frozen_affines,
    "seq1+affine": lambda s: tl.fold_frozen_affines(tl.fold_seq1_attention(s)),
    "affine+seq1": lambda s: tl.fold_seq1_attention(tl.fold_frozen_affines(s)),
}


@pytest.mark.parametrize("fold", list(JFOLDS))
def test_folded_stack_matches_jax_leaf_by_leaf(fold):
    """The port's folded stack, exported through the bridge, against JAX's folded tree:
    the same leaves (``attn/vo``, empty norms, no ``per_dim_scale``) within 1e-6 of the
    largest magnitude (the fold products in fp32, summed in another order); and JAX's
    folded tree loads into the folded module strictly."""
    module, tree = _stack_pair(seed=1)
    ref = JFOLDS[fold](jax.tree.map(jnp.asarray, tree["stacked_xf"]))
    TFOLDS[fold](module.stacked_xf)
    ours = export_jax_params(module)["stacked_xf"]
    assert set(ours) == set(ref)
    for key in ("attn_norm", "ffn_norm"):
        assert (ours[key] == {}) == (ref[key] == {})
    assert set(ours["attn"]) == set(ref["attn"])
    got, want = _leaves(ours), _leaves(ref)
    assert got.keys() == want.keys()
    scale = max(np.abs(v).max() for v in want.values())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6 * scale, err_msg=key)
    load_jax_params(module, {"stacked_xf": jax.tree.map(np.array, ref)})
    for key, value in _leaves(export_jax_params(module)["stacked_xf"]).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)


@pytest.mark.parametrize("fold,seq", [("seq1+affine", 1), ("affine+seq1", 1), ("seq1", 1), ("affine", 16)])
def test_folded_forward_and_input_grad_match_unfolded(fold, seq):
    """Folded against unfolded, fp32, with one left-padded row at S = 16: outputs within
    2e-5 and input gradients within 2e-4 relative + 2e-5 (test_fold_affine.py's bounds:
    the same products reassociated)."""
    module, _ = _stack_pair(seed=2)
    folded = copy.deepcopy(module)
    TFOLDS[fold](folded.stacked_xf)
    rng = np.random.default_rng(seq)
    x = rng.normal(size=(4, seq, MD)).astype(np.float32)
    pad = np.zeros((4, seq), bool)
    pad[1, : seq // 4] = True
    outs, grads = [], []
    for stack in (module.stacked_xf, folded.stacked_xf):
        tx = torch.from_numpy(x).requires_grad_()
        out = stack(tx, torch.from_numpy(pad))
        (g,) = torch.autograd.grad(out.sum(), tx)
        outs.append(out.detach().numpy())
        grads.append(g.numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(grads[1], grads[0], rtol=2e-4, atol=2e-5)


def test_folded_attention_raises_beyond_one_token():
    module, _ = _stack_pair(seed=3)
    tl.fold_seq1_attention(module.stacked_xf)
    with pytest.raises(ValueError, match="folded for seq==1"):
        module.stacked_xf(torch.zeros(2, 3, MD), torch.zeros(2, 3, dtype=torch.bool))


@pytest.mark.parametrize("fold", ["seq1", "affine"])
def test_folds_are_idempotent_and_leave_chronos_unfolded(fold):
    """Folding twice equals folding once, bit for bit; the tree forms return None, and
    change nothing, for a Chronos-2 adapter."""
    module, _ = _stack_pair(seed=5)
    TFOLDS[fold](module.stacked_xf)
    once = _leaves(export_jax_params(module))
    TFOLDS[fold](module.stacked_xf)
    twice = _leaves(export_jax_params(module))
    assert once.keys() == twice.keys()
    for key in once:
        np.testing.assert_array_equal(twice[key], once[key], err_msg=key)

    tree_fold = {"seq1": tl.fold_frozen_tree_seq1, "affine": tl.fold_frozen_tree_affines}[fold]
    chronos = Chronos2Adapter(Chronos2Config.tiny())
    before = _leaves(export_jax_params(chronos))
    assert tree_fold(chronos) is None
    after = _leaves(export_jax_params(chronos))
    assert before.keys() == after.keys()
    assert tree_fold(TimesFM2p5Adapter(TimesFMConfig.tiny())) is not None


def _samples(n, seed, context):
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


def _args_kw(**over):
    kw = dict(
        per_device_train_batch_size=8, per_device_eval_batch_size=4, num_train_epochs=3,
        learning_rate=1e-3, lr_scheduler_type="linear", warmup_steps=1, weight_decay=0.01,
        max_grad_norm=1.0, eval_strategy="epoch", save_strategy="no", logging_strategy="no", seed=7,
    )
    kw.update(over)
    return kw


def _port_trainer(adapter, mode, context, seed=0, **knobs):
    decoder = MultimodalDecoder(adapter, MultimodalDecoderConfig(text_embedding_dims=TEXT), device="cpu")
    load_jax_params(decoder, random_jax_params(decoder, seed))
    args = TrainingArguments(output_dir=tempfile.mkdtemp(), **_args_kw())
    trainer = MultimodalTrainer(decoder, args, _samples(12, 1, context), _samples(4, 2, context), mode,
                                device="cpu", **knobs)
    return decoder, trainer


@pytest.mark.parametrize(
    "mode,context,knobs,seq1,affine",
    [
        ("multimodal", 4, {}, True, True),
        ("multimodal", 16, {}, False, True),
        ("multimodal", 4, {"fold_frozen_seq1": False}, False, True),
        ("multimodal", 4, {"fold_frozen_affine": False}, True, False),
        ("baseline", 4, {}, False, False),
    ],
)
def test_trainer_gates_the_folds(mode, context, knobs, seq1, affine):
    """JAX's gates: multimodal mode, and one patch token on both splits for the seq1 fold.
    The fold lands on a trainer-owned copy: the caller's frozen adapter keeps its
    unfolded weights and the trained child is the caller's own."""
    decoder, trainer = _port_trainer(TimesFM2p5Adapter(TimesFMConfig.tiny()), mode, context, **knobs)
    assert trainer.folded_seq1 == seq1 and trainer._folded_affine == affine
    layer = trainer.model.adapter.stacked_xf.layers[0]
    assert (layer.attn.vo is not None) == seq1
    assert (layer.attn_norm.scale is None) == affine and (layer.ffn_norm.scale is None) == affine
    caller = decoder.adapter.stacked_xf.layers[0]
    assert caller.attn.vo is None and caller.attn.per_dim_scale is not None
    assert caller.attn_norm.scale is not None
    assert getattr(trainer.model, trainer.trainable_key) is getattr(decoder, trainer.trainable_key)
    assert (trainer.model.adapter is decoder.adapter) == (not (seq1 or affine))


def test_trainer_folds_no_chronos_adapter():
    """A Chronos-2 adapter is never folded; the knobs are on by default."""
    _, trainer = _port_trainer(Chronos2Adapter(Chronos2Config.tiny()), "multimodal", 4)
    assert not trainer.folded_seq1 and not trainer._folded_affine


@pytest.fixture(scope="module", params=[4, 16], ids=["context4", "context16"])
def folded_runs(request):
    """The port's and JAX's folded trainers (defaults: both folds on) after 3 epochs of
    multimodal training: context 4 is one patch token (both folds), 16 four (affine)."""
    context = request.param
    port = MultimodalDecoder(TimesFM2p5Adapter(TimesFMConfig.tiny()),
                             MultimodalDecoderConfig(text_embedding_dims=TEXT), device="cpu")
    tree = random_jax_params(port, 11)
    load_jax_params(port, tree)
    jdec = JDecoder(JAdapter(JConfig.tiny()), JDecoderConfig(text_embedding_dims=TEXT))
    train, val = _samples(20, 3, context), _samples(6, 4, context)
    out = tempfile.mkdtemp()
    jt = JTrainer(jdec, jax.tree.map(jnp.asarray, tree), JArgs(output_dir=f"{out}/j", **_args_kw()),
                  train, val, "multimodal", fuse_epochs=False)
    pt = MultimodalTrainer(port, TrainingArguments(output_dir=f"{out}/p", **_args_kw()),
                           train, val, "multimodal", device="cpu")
    ref = [(jt.train_epoch(), jt.validate_epoch()) for _ in range(3)]
    ours = [(pt.train_epoch(), pt.validate_epoch()) for _ in range(3)]
    return context, pt, jt, ours, ref


def test_folded_trainer_matches_jax_trajectory(folded_runs):
    """Per-epoch train and validation losses within rtol 2e-3 and the final fusion
    parameters within 5e-4 (the bounds of tests/test_trajectory_parity.py)."""
    context, pt, jt, ours, ref = folded_runs
    assert pt.folded_seq1 == jt.folded_seq1 == (context == 4)
    assert pt._folded_affine and jt._folded_affine
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    got, want = _leaves(export_jax_params(pt.trainable_module)), _leaves(jax.device_get(jt.state.trainable))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=5e-4, err_msg=key)


def test_folded_trainer_frozen_tree_matches_jax(folded_runs):
    """The trainer's folded frozen adapter against JAX's ``trainer.frozen["adapter"]``, leaf
    by leaf within 1e-6 of the largest magnitude."""
    _, pt, jt, _, _ = folded_runs
    got, want = _leaves(export_jax_params(pt.model.adapter)), _leaves(jt.frozen["adapter"])
    assert got.keys() == want.keys()
    scale = max(np.abs(v).max() for v in want.values())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6 * scale, err_msg=key)
