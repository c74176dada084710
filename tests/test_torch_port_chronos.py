"""PyTorch port vs the JAX package: the Chronos-2 adapter, its gradients, the trainer, the bridge.

Both packages get the same parameters (a numpy tree drawn from a seed and
loaded into the port through ``models/bridge.py``) and the same numpy inputs,
at ``Chronos2Config.tiny()``; the port runs on the CPU through the plain
composition of JAX's default encoder path, as JAX does off the TPU.
Forecasts are compared in units of the reference's standard deviation.
Tolerances are stated beside each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_timesfm_tpu.inference import Forecaster as JForecaster
from multimodal_timesfm_tpu.models import chronos as jc
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoder as JDecoder
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoderConfig as JDecoderConfig
from multimodal_timesfm_tpu.training.trainer import MultimodalTrainer as JTrainer
from multimodal_timesfm_tpu.training_args import TrainingArguments as JArgs
from multimodal_timesfm_torch.inference import Forecaster
from multimodal_timesfm_torch.models import bridge
from multimodal_timesfm_torch.models import chronos as tc
from multimodal_timesfm_torch.models.bridge import export_jax_params, load_jax_params, random_jax_params
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
from multimodal_timesfm_torch.training_args import TrainingArguments

TEXT = 6
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Forecasts, absolute in units of the reference's std. fp32: summation order
# (measured <= 1.1e-5, outputs near 100 where an fp32 ulp is 7.6e-6). bf16:
# measured <= 0.087; the port's encoder is bit-equal to JAX's when XLA runs
# with --xla_allow_excess_precision=false, so the difference is XLA on the CPU
# keeping some bf16 intermediates in fp32 (a few bf16 ulps at |h| ~ 2.5).
STD_TOL = {"float32": 2e-5, "bfloat16": 0.12}


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


def _pair(dtype="float32", seed=0, **config):
    """(port decoder on the CPU, JAX decoder, the numpy tree both hold)."""
    cfg = dataclasses.replace(tc.Chronos2Config.tiny(), compute_dtype=TDT[dtype], **config)
    port = MultimodalDecoder(
        tc.Chronos2Adapter(cfg), MultimodalDecoderConfig(text_embedding_dims=TEXT), device="cpu"
    )
    tree = random_jax_params(port, seed)
    load_jax_params(port, tree)
    jcfg = dataclasses.replace(jc.Chronos2Config.tiny(), compute_dtype=JDT[dtype], **config)
    return port, JDecoder(jc.Chronos2Adapter(jcfg), JDecoderConfig(text_embedding_dims=TEXT)), tree


def _assert_close(out, ref, dtype):
    ref = np.asarray(ref, np.float32)
    out = np.asarray(out, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=STD_TOL[dtype] * ref.std())


def _inputs(batch=4, context=16, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(batch, context)) * 5 + 100).astype(np.float32)
    m = np.zeros((batch, context), bool)
    m[1, :5] = True  # left padding: one whole patch and one point of the next
    m[3, :8] = True
    text = rng.normal(size=(batch, context // 4, TEXT)).astype(np.float32)
    return x, m, text


# ---------------------------------------------------------------------------
# the pieces: buckets, config, instance norm, preprocess, encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("buckets,distance", [(32, 128), (8, 16), (4, 8)])
def test_relative_bucket_equals_jax(buckets, distance):
    """Integer-equal over |rel| <= 2048: the float32 log ratio rounds as JAX's does."""
    rel = np.arange(-2048, 2049)
    ref = np.asarray(jc._relative_bucket(jnp.asarray(rel), buckets, distance))
    out = tc._relative_bucket(torch.from_numpy(rel), buckets, distance).numpy()
    np.testing.assert_array_equal(out, ref)


def test_config_checks_and_hf_loader():
    for bad in (dict(rel_pos_buckets=3), dict(input_patch_size=8)):
        with pytest.raises(ValueError):
            tc.Chronos2Config(**bad)
    default = tc.Chronos2Config()
    assert (default.model_dim, default.num_layers, default.num_heads, default.head_dim) == (768, 16, 12, 64)
    # The snapshot loader maps config.json onto the config (models/snapshot.py).
    assert tc.Chronos2Adapter.config_from_hf({}) == default
    cfg = tc.Chronos2Adapter.config_from_hf({"chronos_config": {"d_model": 64, "num_heads": 4}})
    assert (cfg.model_dim, cfg.num_heads, cfg.num_layers) == (64, 4, 16)


def test_instance_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 8)) * 4 + 10).astype(np.float32)
    x[2] = 5.0  # a constant series: scale 1
    valid = np.ones((3, 8), np.float32)
    valid[0, :3] = 0.0
    valid[1] = 0.0  # no valid point: count clamped at 1
    ref = jc.instance_norm_stats(jnp.asarray(x), jnp.asarray(valid))
    out = tc.instance_norm_stats(torch.from_numpy(x), torch.from_numpy(valid))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)
    assert out[1][2, 0] == 1.0
    back = tc.instance_norm_inverse(torch.ones(3, 2, 4), *out)
    np.testing.assert_allclose(back.numpy(), np.asarray(jc.instance_norm_inverse(jnp.ones((3, 2, 4)), *ref)))


@pytest.mark.parametrize("pack", [1, 2])
def test_preprocess_and_encoder_match_jax(pack):
    port, jdec, tree = _pair()
    x, m, _ = _inputs()
    jparams = jax.tree.map(jnp.asarray, tree["adapter"])
    jpre = jdec.adapter.preprocess(jparams, jnp.asarray(x), jnp.asarray(m))
    with torch.inference_mode():
        pre = port.adapter.preprocess(torch.from_numpy(x), torch.from_numpy(m))
        hidden = port.adapter(pre.input_embeddings, pre.masks, pack=pack)
    np.testing.assert_array_equal(pre.masks.numpy(), np.asarray(jpre.masks))
    np.testing.assert_allclose(pre.input_embeddings.numpy(), np.asarray(jpre.input_embeddings), atol=1e-5)
    for key in ("loc", "scale"):
        np.testing.assert_allclose(pre.normalization_stats[key].numpy(),
                                   np.asarray(jpre.normalization_stats[key]), rtol=1e-6)
    ref = jdec.adapter.forward(jparams, jpre.input_embeddings, jpre.masks, pack=pack)
    assert hidden.shape == (4, 4, 32)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pack", [1, 2])
@pytest.mark.parametrize("with_text", [False, True])
def test_forward_full_matches_jax(with_text, pack, dtype):
    port, jdec, tree = _pair(dtype, seed=pack, pack=pack)
    x, m, text = _inputs(seed=pack)
    text = text if with_text else None
    ref = jdec.forward_full(jax.tree.map(jnp.asarray, tree), 12, jnp.asarray(x), jnp.asarray(m),
                            None if text is None else jnp.asarray(text))
    with torch.inference_mode():
        out = port.forward_full(12, torch.from_numpy(x), torch.from_numpy(m),
                                None if text is None else torch.from_numpy(text))
    assert out.dtype == torch.float32 and out.shape == (4, 12, 9)
    _assert_close(out.numpy(), ref, dtype)


def test_horizon_guard_and_pack_divisibility():
    port, _, _ = _pair()
    x, m = torch.zeros(3, 16), torch.zeros(3, 16, dtype=torch.bool)
    with pytest.raises(ValueError, match="exceeds the maximum"):
        port.forward_full(17, x, m)
    pre = port.adapter.preprocess(x, m)
    with pytest.raises(ValueError, match="divisible"):
        port.adapter(pre.input_embeddings, pre.masks, pack=2)
    assert port.adapter.point_forecast_index == 4
    assert port.adapter.quantile_loss_spec == jc.Chronos2Adapter(jc.Chronos2Config.tiny()).quantile_loss_spec


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def _point_loss(port, x, text, horizon, weights):
    point = port(8, torch.from_numpy(x), torch.zeros(x.shape, dtype=torch.bool),
                 None if text is None else torch.from_numpy(text))
    err = (point.float() - torch.from_numpy(horizon)) ** 2
    return (err * torch.from_numpy(weights)[:, None]).sum() / (weights.sum() * 8)


def test_remat_gives_equal_gradients():
    x, _, _ = _inputs()
    horizon = np.random.default_rng(2).normal(size=(4, 8)).astype(np.float32)
    weights = np.ones(4, np.float32)
    grads = []
    for remat in (False, True):
        port, _, _ = _pair(seed=5, remat=remat)
        loss = _point_loss(port, x, None, horizon, weights)
        grads.append(torch.autograd.grad(loss, list(port.adapter.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


# fp32: every element within 1e-5 of the largest reference gradient (summation
# order). bf16: every leaf within 0.15 in norm (measured <= 0.102, at the FFN
# norm gains of the baseline case): XLA on the CPU keeps some bf16
# intermediates in fp32 (see STD_TOL), and a ReLU input near 0 may then round
# to the other side.
GRAD_TOL = {"float32": 1e-5, "bfloat16": 0.15}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["multimodal", "baseline"])
def test_decoder_gradients_match_jax(mode, dtype):
    """The trainer's weighted MSE (one zero-weight row) w.r.t. the trained subtree: the
    fusion MLP (multimodal) or the whole adapter, rel_pos_bias and shared included."""
    port, jdec, tree = _pair(dtype, seed=7)
    key = "fusion" if mode == "multimodal" else "adapter"
    x, _, text = _inputs(seed=8)
    text = text if mode == "multimodal" else None
    horizon = (np.random.default_rng(9).normal(size=(4, 8)) * 5 + 100).astype(np.float32)
    weights = np.array([1.0, 1.0, 1.0, 0.0], np.float32)

    def j_loss(sub):
        params = dict(jax.tree.map(jnp.asarray, tree))
        params[key] = sub
        point = jdec(params, 8, jnp.asarray(x), jnp.zeros(x.shape, bool),
                     None if text is None else jnp.asarray(text))
        err = (point.astype(jnp.float32) - horizon) ** 2
        return jnp.sum(err * weights[:, None]) / (weights.sum() * 8)

    ref = _leaves(jax.jit(jax.grad(j_loss))(jax.tree.map(jnp.asarray, tree[key])))
    sub = getattr(port, key)
    port.requires_grad_(False)
    sub.requires_grad_(True)
    grads = torch.autograd.grad(_point_loss(port, x, text, horizon, weights), list(sub.parameters()))
    ours = _leaves(export_jax_params(sub, dict(zip(sub.parameters(), grads))))
    assert ours.keys() == ref.keys()
    if mode == "baseline":
        assert {"/encoder/rel_pos_bias", "/shared"} <= ours.keys()
        assert np.abs(ours["/encoder/rel_pos_bias"]).max() > 0
    scale = max(np.abs(v).max() for v in ref.values())
    for name in ref:
        if dtype == "float32":
            np.testing.assert_allclose(ours[name], ref[name], rtol=0, atol=GRAD_TOL[dtype] * scale, err_msg=name)
        else:
            err = np.linalg.norm(ours[name] - ref[name])
            assert err <= GRAD_TOL[dtype] * np.linalg.norm(ref[name]) + 1e-12, (name, err)


# ---------------------------------------------------------------------------
# the trainer and the Forecaster
# ---------------------------------------------------------------------------


def _samples(n, seed, context=16):
    rng = np.random.default_rng(seed)
    return [
        {
            "context": (rng.normal(size=context) + np.sin(np.arange(context))).astype(np.float32),
            "horizon": rng.normal(size=8).astype(np.float32),
            "text_embeddings": rng.normal(size=(context // 4, TEXT)).astype(np.float32),
            "metadata": {"mean": float(rng.normal()), "std": float(rng.uniform(0.5, 2.0))},
        }
        for _ in range(n)
    ]


@pytest.mark.parametrize("mode", ["multimodal", "baseline"])
def test_trainer_matches_jax(tmp_path, mode):
    """20 series in batches of 8 (the last padded), 3 epochs with validation, same seed:
    per-epoch losses within rtol 2e-3 and final parameters within 5e-4, the bounds of
    tests/test_trajectory_parity.py (fp32 noise carried through Adam's normalisation)."""
    port, jdec, tree = _pair(seed=3)
    train, val = _samples(20, 1), _samples(6, 2)
    kw = dict(
        per_device_train_batch_size=8, per_device_eval_batch_size=4, num_train_epochs=3,
        learning_rate=1e-3, lr_scheduler_type="linear", warmup_steps=1, weight_decay=0.01,
        max_grad_norm=1.0, eval_strategy="epoch", save_strategy="no", logging_strategy="no", seed=7,
    )
    jt = JTrainer(jdec, jax.tree.map(jnp.asarray, tree), JArgs(output_dir=str(tmp_path / "j"), **kw),
                  train, val, mode, fuse_epochs=False)
    pt = MultimodalTrainer(port, TrainingArguments(output_dir=str(tmp_path / "p"), **kw),
                           train, val, mode, device="cpu")
    ours = [(pt.train_epoch(), pt.validate_epoch()) for _ in range(3)]
    ref = [(jt.train_epoch(), jt.validate_epoch()) for _ in range(3)]
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    ours_p, ref_p = _leaves(export_jax_params(pt.trainable_module)), _leaves(jax.device_get(jt.state.trainable))
    assert ours_p.keys() == ref_p.keys()
    for name in ref_p:
        np.testing.assert_allclose(ours_p[name], ref_p[name], atol=5e-4, err_msg=name)


def test_forecaster_serves_chronos_like_jax():
    port, jdec, tree = _pair(seed=4)
    samples = _samples(5, 11)
    jf = JForecaster(jdec, jax.tree.map(jnp.asarray, tree), batch_size=4)
    pf = Forecaster(port, batch_size=4, device="cpu")
    _assert_close(pf.forecast_dataset(16, samples, denormalize=True),
                  jf.forecast_dataset(16, samples, denormalize=True), "float32")


# ---------------------------------------------------------------------------
# the bridge, and the repairs that came with the Chronos slice
# ---------------------------------------------------------------------------


def test_bridge_round_trip_of_a_chronos_tree_is_strict():
    """Load then export gives the tree back; the stacked encoder layers keep their
    ``layers`` level and a leading L axis, the tables keep their JAX layout."""
    port, jdec, tree = _pair(seed=6)
    out = export_jax_params(port)
    assert _leaves(out).keys() == _leaves(tree).keys()
    for name, value in _leaves(tree).items():
        np.testing.assert_array_equal(_leaves(out)[name], value, err_msg=name)
    jtree = jax.device_get(jdec.init(jax.random.key(0)))
    assert {k: v.shape for k, v in _leaves(jtree).items()} == {k: v.shape for k, v in _leaves(tree).items()}
    enc = tree["adapter"]["encoder"]
    assert enc["layers"]["attn"]["q"]["kernel"].shape == (2, 32, 32)
    assert enc["rel_pos_bias"].shape == (32, 2) and tree["adapter"]["shared"].shape == (2, 32)
    np.testing.assert_array_equal(port.adapter.encoder.rel_pos_bias.detach().numpy(), enc["rel_pos_bias"])
    np.testing.assert_array_equal(port.adapter.encoder.layers[1].attn.q.weight.detach().numpy(),
                                  enc["layers"]["attn"]["q"]["kernel"][1].T)
    del tree["adapter"]["encoder"]["rel_pos_bias"]
    with pytest.raises(ValueError, match="missing.*adapter/encoder/rel_pos_bias"):
        load_jax_params(port, tree)


def _draw_by_path_suffix(module, seed):
    """The draw before the repair: +1 on every leaf whose path ends in ffn_norm/scale."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, shape in bridge.expected_shapes(module).items():
        if path.endswith("/kernel"):
            limit = np.sqrt(6.0 / (shape[-2] + shape[-1]))
            leaf = rng.uniform(-limit, limit, shape)
        else:
            leaf = rng.normal(0.0, 0.05, shape)
            if path.endswith("ffn_norm/scale"):
                leaf += 1.0
        flat["/" + path] = leaf.astype(np.float32)
    return flat


def test_random_params_add_one_to_layer_norm_gains_only():
    """TimesFM's draw is bit-identical to the rule it replaces; Chronos's RMS gains, which
    apply 1 + scale themselves, are drawn around 0 and not around 1."""
    timesfm = MultimodalDecoder(TimesFM2p5Adapter(TimesFMConfig.tiny()),
                                MultimodalDecoderConfig(text_embedding_dims=TEXT), device="cpu")
    old, new = _draw_by_path_suffix(timesfm, 5), _leaves(random_jax_params(timesfm, 5))
    assert old.keys() == new.keys()
    for name in old:
        np.testing.assert_array_equal(new[name], old[name], err_msg=name)
    port, _, _ = _pair()
    chronos = _leaves(random_jax_params(port, 5))
    assert abs(chronos["/adapter/encoder/layers/ffn_norm/scale"].mean()) < 0.05
    assert abs(new["/adapter/stacked_xf/ffn_norm/scale"].mean() - 1.0) < 0.05


@pytest.mark.parametrize("with_text", [False, True])
def test_autoregressive_forecast_of_chronos_is_the_single_shot(with_text):
    """Chronos has no output_patch_len: a horizon of three patches is one native forecast,
    as JAX's Forecaster returns it."""
    port, jdec, tree = _pair(seed=8)
    x, _, text = _inputs(batch=5, seed=10)
    text = text if with_text else None
    pf = Forecaster(port, batch_size=4, device="cpu")
    out = pf.forecast_autoregressive(12, x, text_embeddings=text, text_mode="error")
    np.testing.assert_array_equal(out, pf.forecast(12, x, text_embeddings=text))
    jf = JForecaster(jdec, jax.tree.map(jnp.asarray, tree), batch_size=4)
    _assert_close(out, jf.forecast_autoregressive(12, x, text_embeddings=text), "float32")


def test_chip_smoke_kernel_entries_carry_their_own_geometry():
    """Each entry of chip_smoke.py's ``kernels`` line names its own (B, S, H, D): the
    Chronos kernels run H=12 D=64, the TimesFM ones H=16 D=80."""
    rows = {chip_smoke.row_key(key, shape, torch.bfloat16): {"ms": float(i)}
            for i, (key, *_, shape) in enumerate(chip_smoke.KERNELS)}
    entries = chip_smoke.kernel_entries(rows, {key: 1 for key, *_ in chip_smoke.KERNELS})
    shapes = {e["name"]: e["shape"] for e in entries}
    assert len(entries) == 8 and len(shapes) == 8
    assert shapes["fused_chronos_attention"] == shapes["fused_chronos_attention_bwd"] == "B=128 S=67 H=12 D=64 bfloat16"
    assert shapes["fused_qkv_causal_attention"] == "B=64 S=64 H=16 D=80 bfloat16"
    assert shapes["flash_causal_attention"] == "B=2 S=2100 H=16 D=80 bfloat16"
    assert [e["ms"] for e in entries] == [float(i) for i in range(8)]
