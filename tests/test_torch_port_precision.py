"""bf16 weight storage in the PyTorch port against the JAX package.

``dense`` with bf16 x and bf16 weights (forward and VJP), the trainer's
``frozen_cast_dtype`` (after the folds, following ``tests/test_fold_seq1.py``)
and ``trainable_cast_dtype`` (fp32 masters, following
``tests/test_trainer.py``'s mixed-precision trajectory), and ``Forecaster``
serving a decoder whose weights are stored in bf16, against JAX's on a
bf16-cast params tree. Inputs are numpy draws from a seed; the port runs on
the CPU, where the bf16 GEMM is the same products in fp32. Tolerances are
stated beside each test.
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.inference import Forecaster as JForecaster
from multimodal_timesfm_tpu.models import chronos as jc
from multimodal_timesfm_tpu.models import layers as jl
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoder as JDecoder
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoderConfig as JDecoderConfig
from multimodal_timesfm_tpu.models.timesfm import TimesFM2p5Adapter as JAdapter
from multimodal_timesfm_tpu.models.timesfm import TimesFMConfig as JConfig
from multimodal_timesfm_tpu.training.trainer import MultimodalTrainer as JTrainer
from multimodal_timesfm_tpu.training_args import TrainingArguments as JArgs
from multimodal_timesfm_torch.inference import Forecaster
from multimodal_timesfm_torch.models import chronos as tc
from multimodal_timesfm_torch.models import layers as tl
from multimodal_timesfm_torch.models.bridge import export_jax_params, load_jax_params, random_jax_params
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
from multimodal_timesfm_torch.training_args import TrainingArguments

TEXT = 6
BF16_ULP = 2.0**-7  # relative spacing of bf16 just above a power of two


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


@pytest.mark.parametrize("bias", [None, "float32", "bfloat16"])
def test_bf16_dense_forward_and_vjp_match_jax(bias):
    """bf16 x and kernel: forward, dx, dW and db against ``jax.vjp`` of JAX ``dense``. Each
    side rounds an fp32 accumulator once to bf16, the sums taken in another order:
    within one bf16 ulp (2^-7 relative) of JAX, plus 2^-7 of the largest magnitude for
    elements whose sum cancels; the fp32 bias gradient within 1e-5 relative."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    kernel = rng.normal(size=(24, 40)).astype(np.float32) * 0.2
    b = rng.normal(size=40).astype(np.float32)
    cot = rng.normal(size=(3, 5, 40)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

    params = {"kernel": jnp.asarray(kernel, jnp.bfloat16)}
    if bias is not None:
        params["bias"] = jnp.asarray(b, jdt[bias])
    ref, vjp = jax.vjp(jl.dense, params, jnp.asarray(x, jnp.bfloat16))
    jparams_bar, jx_bar = vjp(jnp.asarray(cot, jnp.bfloat16))

    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(kernel.T.copy()).to(torch.bfloat16).requires_grad_()
    tb = None if bias is None else torch.from_numpy(b).to(getattr(torch, bias)).requires_grad_()
    out = tl.dense(tx, tw, tb)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, [t for t in (tx, tw, tb) if t is not None],
                                torch.from_numpy(cot).to(torch.bfloat16))
    pairs = [(out, ref), (grads[0], jx_bar), (grads[1].t(), jparams_bar["kernel"])]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=BF16_ULP,
                                   atol=BF16_ULP * np.abs(want).max())
    if bias is not None:
        assert grads[2].dtype == tb.dtype
        np.testing.assert_allclose(grads[2].float().numpy(), np.asarray(jparams_bar["bias"], np.float32),
                                   rtol=1e-5 if bias == "float32" else BF16_ULP)


def test_mixed_dense_promotes_to_fp32_like_jax():
    """bf16 x with an fp32 weight, and fp32 x with a bf16 weight: both operands in fp32,
    the result in x's dtype, as JAX promotes (one rounding of the same fp32 sum)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    kernel = rng.normal(size=(16, 8)).astype(np.float32)
    for x_dt, w_dt in ((jnp.bfloat16, jnp.float32), (jnp.float32, jnp.bfloat16)):
        ref = jl.dense({"kernel": jnp.asarray(kernel, w_dt)}, jnp.asarray(x, x_dt))
        tx = torch.from_numpy(x).to(torch.bfloat16 if x_dt == jnp.bfloat16 else torch.float32)
        tw = torch.from_numpy(kernel.T.copy()).to(torch.bfloat16 if w_dt == jnp.bfloat16 else torch.float32)
        out = tl.dense(tx, tw)
        assert out.dtype == tx.dtype
        want = np.asarray(ref, np.float32)
        np.testing.assert_allclose(out.float().numpy(), want, rtol=BF16_ULP, atol=1e-5)


def _samples(n, seed, context, text=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = {
            "context": (rng.normal(size=context) + np.sin(np.arange(context))).astype(np.float32),
            "horizon": rng.normal(size=8).astype(np.float32),
            "metadata": {"mean": float(rng.uniform(-5, 5)), "std": float(rng.uniform(0.5, 2))},
        }
        if text:
            s["text_embeddings"] = rng.normal(size=(context // 4, TEXT)).astype(np.float32)
        out.append(s)
    return out


def _args_kw(**over):
    kw = dict(
        per_device_train_batch_size=8, per_device_eval_batch_size=4, num_train_epochs=3,
        learning_rate=5e-3, lr_scheduler_type="linear", warmup_steps=1, weight_decay=0.01,
        max_grad_norm=1.0, eval_strategy="epoch", save_strategy="no", logging_strategy="no", seed=7,
    )
    kw.update(over)
    return kw


def _pair(compute, seed):
    """(port decoder on the CPU, JAX decoder, the numpy tree both hold), TimesFM tiny."""
    port = MultimodalDecoder(
        TimesFM2p5Adapter(dataclasses.replace(TimesFMConfig.tiny(), compute_dtype=getattr(torch, compute))),
        MultimodalDecoderConfig(text_embedding_dims=TEXT), device="cpu",
    )
    tree = random_jax_params(port, seed)
    load_jax_params(port, tree)
    jdec = JDecoder(JAdapter(dataclasses.replace(JConfig.tiny(), compute_dtype=getattr(jnp, compute))),
                    JDecoderConfig(text_embedding_dims=TEXT))
    return port, jdec, tree


def _run_pair(mode, context, compute, seed, epochs, args_over, port_knobs, jax_knobs):
    port, jdec, tree = _pair(compute, seed)
    text = mode == "multimodal"
    train, val = _samples(20, seed + 1, context, text), _samples(6, seed + 2, context, text)
    out = tempfile.mkdtemp()
    kw = _args_kw(num_train_epochs=epochs, **args_over)
    jt = JTrainer(jdec, jax.tree.map(jnp.asarray, tree), JArgs(output_dir=f"{out}/j", **kw),
                  train, val, mode, fuse_epochs=False, **jax_knobs)
    pt = MultimodalTrainer(port, TrainingArguments(output_dir=f"{out}/p", **kw), train, val, mode,
                           device="cpu", **port_knobs)
    ref = [(jt.train_epoch(), jt.validate_epoch()) for _ in range(epochs)]
    ours = [(pt.train_epoch(), pt.validate_epoch()) for _ in range(epochs)]
    return port, pt, jt, np.asarray(ours), np.asarray(ref)


@pytest.fixture(scope="module", params=[4, 16], ids=["context4", "context16"])
def frozen_cast_runs(request):
    """Multimodal bf16 training with the frozen adapter folded and then stored in bf16,
    port and JAX, 3 epochs: context 4 folds both, 16 the affines only."""
    return _run_pair("multimodal", request.param, "bfloat16", 21, 3, {},
                     {"frozen_cast_dtype": torch.bfloat16}, {"frozen_cast_dtype": jnp.bfloat16})


def test_frozen_cast_trainer_matches_jax(frozen_cast_runs):
    """Losses within 2e-2 relative (bf16 activations in 2 layers, rounded at the same
    places, a few ulps apart: the bound of tests/test_fold_seq1.py's cast test) and the
    trained fusion weights within 2e-2 in norm per leaf."""
    port, pt, jt, ours, ref = frozen_cast_runs
    np.testing.assert_allclose(ours, ref, rtol=2e-2)
    got, want = _leaves(export_jax_params(pt.trainable_module)), _leaves(jax.device_get(jt.state.trainable))
    for key in want:
        assert np.linalg.norm(got[key] - want[key]) <= 2e-2 * np.linalg.norm(want[key]), key


def test_frozen_cast_tree_matches_jax(frozen_cast_runs):
    """The trainer's frozen adapter is bf16 and equals JAX's folded-then-cast frozen tree
    leaf by leaf within one bf16 ulp (the fp32 fold products, summed in another order,
    may round to neighbouring bf16 values); the caller's adapter stays fp32."""
    port, pt, jt, _, _ = frozen_cast_runs
    assert all(p.dtype == torch.bfloat16 for p in pt.model.adapter.parameters())
    assert all(p.dtype == torch.float32 for p in port.adapter.parameters())
    assert all(p.dtype == torch.float32 for p in pt.trainable)
    got, want = _leaves(export_jax_params(pt.model.adapter)), _leaves(jt.frozen["adapter"])
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=BF16_ULP, atol=1e-30, err_msg=key)


@pytest.mark.parametrize("fused_optimizer", [False, True])
def test_trainable_cast_trajectory_matches_jax(fused_optimizer):
    """Baseline mode with ``trainable_cast_dtype=bf16`` and bf16 Adam moments (JAX's
    mixed-precision trajectory test: fp32 compute, 4 epochs, lr 5e-3), port against JAX,
    chain and fused optimizers. Tolerances: losses within 3e-2 relative and the fp32
    masters within 5e-2 in norm per leaf (measured 1.95e-2 and 3.1e-2). Without the cast
    the two agree to 5e-6; with it the weights and gradients are bf16, and XLA's compiled
    CPU program keeps some bf16 intermediates of the weights in fp32 where the port rounds
    them (JAX's own jit and eager forwards of the cast stack differ by 1e-2 after two
    layers); Adam's first steps, about lr x sign(g), carry the difference. The masters
    stay fp32 on both sides."""
    _, pt, jt, ours, ref = _run_pair(
        "baseline", 16, "float32", 31, 4, {"adam_moment_dtype": "bfloat16"},
        {"trainable_cast_dtype": torch.bfloat16, "fused_optimizer": fused_optimizer},
        {"trainable_cast_dtype": jnp.bfloat16, "fused_optimizer": fused_optimizer},
    )
    np.testing.assert_allclose(ours, ref, rtol=3e-2)
    assert all(p.dtype == torch.float32 for p in pt.trainable)
    assert all(p.dtype == torch.bfloat16 for p in pt._work)
    masters = jax.device_get(jt.state.trainable)
    assert all(np.asarray(v).dtype == np.float32 for v in jax.tree.leaves(masters))
    got, want = _leaves(export_jax_params(pt.trainable_module)), _leaves(masters)
    for key in want:
        assert np.linalg.norm(got[key] - want[key]) <= 5e-2 * np.linalg.norm(want[key]) + 1e-6, key


# As tests/test_torch_port_forecast.py (TimesFM) and test_torch_port_chronos.py
# (Chronos-2, where XLA on the CPU keeps some bf16 intermediates in fp32):
# max |port - JAX| <= TOL x std(JAX forecasts).
BF16_STD_TOL = {"timesfm": 0.04, "chronos": 0.12}


@pytest.mark.parametrize("backbone", ["timesfm", "chronos"])
def test_forecaster_serves_a_bf16_stored_decoder_like_jax(backbone):
    """A decoder whose every weight is stored in bf16, served in bf16 through Forecaster
    (text, a ragged last batch, denormalized), against JAX's Forecaster on the same tree
    cast to bf16."""
    if backbone == "timesfm":
        port, jdec, tree = _pair("bfloat16", 41)
        context, horizon = 16, 8
    else:
        cfg = dataclasses.replace(tc.Chronos2Config.tiny(), compute_dtype=torch.bfloat16)
        port = MultimodalDecoder(tc.Chronos2Adapter(cfg), MultimodalDecoderConfig(text_embedding_dims=TEXT),
                                 device="cpu")
        tree = random_jax_params(port, 41)
        load_jax_params(port, tree)
        jcfg = dataclasses.replace(jc.Chronos2Config.tiny(), compute_dtype=jnp.bfloat16)
        jdec = JDecoder(jc.Chronos2Adapter(jcfg), JDecoderConfig(text_embedding_dims=TEXT))
        context, horizon = 16, 12
    port.to(torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in port.parameters())
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    samples = _samples(5, 43, context)
    ours = Forecaster(port, batch_size=4, device="cpu").forecast_dataset(horizon, samples, denormalize=True)
    ref = JForecaster(jdec, jtree, batch_size=4).forecast_dataset(horizon, samples, denormalize=True)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=BF16_STD_TOL[backbone] * ref.std())
