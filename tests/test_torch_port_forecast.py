"""PyTorch port vs the JAX package: the decoder, the Forecaster and the weight bridge.

Both packages get the same parameters (a numpy tree drawn from a seed, loaded
into the port through ``models/bridge.py``) and the same numpy inputs; the
port runs on the CPU through its plain attention path, as JAX does off the
TPU. Tolerances are absolute, in units of the reference forecasts' standard
deviation: fp32 differs in summation order only (measured 1.6e-6); bf16 rounds
activations at the same places in both packages (swish included), a few ulps
apart through the norms and the softmax (measured 0.026).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.inference import Forecaster as JForecaster
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoder as JDecoder
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoderConfig as JDecoderConfig
from multimodal_timesfm_tpu.models.timesfm import TimesFM2p5Adapter as JAdapter
from multimodal_timesfm_tpu.models.timesfm import TimesFMConfig as JConfig
from multimodal_timesfm_torch.inference import Forecaster
from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig

TEXT = 6
STD_TOL = {"float32": 2e-5, "bfloat16": 0.04}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(dtype="float32", seed=0, **config):
    """(port decoder on the CPU, JAX decoder, JAX params): same weights."""
    port = MultimodalDecoder(
        TimesFM2p5Adapter(
            dataclasses.replace(TimesFMConfig.tiny(), compute_dtype=TDT[dtype], **config)
        ),
        MultimodalDecoderConfig(text_embedding_dims=TEXT),
        device="cpu",
    )
    tree = random_jax_params(port, seed)
    load_jax_params(port, tree)
    jdec = JDecoder(
        JAdapter(dataclasses.replace(JConfig.tiny(), compute_dtype=JDT[dtype], **config)),
        JDecoderConfig(text_embedding_dims=TEXT),
    )
    return port, jdec, jax.tree.map(jnp.asarray, tree)


def _assert_close(out, ref, dtype):
    ref = np.asarray(ref, np.float32)
    out = np.asarray(out, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=STD_TOL[dtype] * ref.std())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [1, 16, 64])
@pytest.mark.parametrize("with_text", [False, True])
def test_forward_full_matches_jax(tokens, with_text, dtype):
    port, jdec, jparams = _pair(dtype)
    rng = np.random.default_rng(tokens)
    context = tokens * 4  # tiny patch length 4
    x = (rng.normal(size=(3, context)) * 5 + 100).astype(np.float32)
    m = np.zeros((3, context), bool)
    m[1, : context // 3] = True  # left padding
    text = rng.normal(size=(3, tokens, TEXT)).astype(np.float32) if with_text else None
    ref = jdec.forward_full(
        jparams, 8, jnp.asarray(x), jnp.asarray(m), None if text is None else jnp.asarray(text)
    )
    with torch.inference_mode():
        out = port.forward_full(
            8, torch.from_numpy(x), torch.from_numpy(m),
            None if text is None else torch.from_numpy(text),
        )
    assert out.dtype == torch.float32 and out.shape == (3, 8, 10)
    _assert_close(out.numpy(), ref, dtype)


def _samples(n, context, seed):
    rng = np.random.default_rng(seed)
    return [
        {
            "context": rng.normal(size=context).astype(np.float32),
            "horizon": rng.normal(size=8).astype(np.float32),
            "text_embeddings": rng.normal(size=(context // 4, TEXT)).astype(np.float32),
            "metadata": {"mean": float(rng.uniform(-5, 5)), "std": float(rng.uniform(0.5, 3))},
        }
        for _ in range(n)
    ]


def test_forecast_ragged_batches_match_jax():
    port, jdec, jparams = _pair()
    rng = np.random.default_rng(10)
    ctx = rng.normal(size=(11, 16)).astype(np.float32)  # 11 = 4 + 4 + 3 (padded)
    text = rng.normal(size=(11, 4, TEXT)).astype(np.float32)
    jf = JForecaster(jdec, jparams, batch_size=4)
    pf = Forecaster(port, batch_size=4, device="cpu")
    _assert_close(pf.forecast(8, ctx), jf.forecast(8, ctx), "float32")
    _assert_close(
        pf.forecast(8, ctx, text_embeddings=text, full=True),
        jf.forecast(8, ctx, text_embeddings=text, full=True),
        "float32",
    )


def test_forecast_dataset_denormalize_matches_jax():
    port, jdec, jparams = _pair(seed=1)
    samples = _samples(5, 16, 11)
    jf = JForecaster(jdec, jparams, batch_size=4)
    pf = Forecaster(port, batch_size=4, device="cpu")
    out = pf.forecast_dataset(8, samples, denormalize=True)
    _assert_close(out, jf.forecast_dataset(8, samples, denormalize=True), "float32")
    raw = pf.forecast_dataset(8, samples)
    std = np.array([s["metadata"]["std"] for s in samples])[:, None]
    mean = np.array([s["metadata"]["mean"] for s in samples])[:, None]
    np.testing.assert_allclose(out, raw * std + mean, rtol=1e-5, atol=1e-5)
    assert not np.allclose(raw, pf.forecast_dataset(8, samples, multimodal=False))


def test_forecast_autoregressive_matches_jax():
    port, jdec, jparams = _pair(seed=2)
    rng = np.random.default_rng(12)
    ctx = rng.normal(size=(5, 16)).astype(np.float32)
    text = rng.normal(size=(5, 4, TEXT)).astype(np.float32)
    jf = JForecaster(jdec, jparams, batch_size=4)
    pf = Forecaster(port, batch_size=4, device="cpu")
    long_preds = pf.forecast_autoregressive(20, ctx)  # 3 rounds of 8
    assert long_preds.shape == (5, 20)
    _assert_close(long_preds, jf.forecast_autoregressive(20, ctx), "float32")
    with pytest.warns(UserWarning, match="FIRST window"):
        fused = pf.forecast_autoregressive(20, ctx, text_embeddings=text)
    with pytest.warns(UserWarning):
        jfused = jf.forecast_autoregressive(20, ctx, text_embeddings=text)
    _assert_close(fused, jfused, "float32")
    with pytest.raises(ValueError, match="text_mode='error'"):
        pf.forecast_autoregressive(20, ctx, text_embeddings=text, text_mode="error")
    short = pf.forecast_autoregressive(8, ctx, text_embeddings=text, text_mode="error")
    np.testing.assert_allclose(short, pf.forecast(8, ctx, text_embeddings=text), rtol=0, atol=0)


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    adapter = TimesFM2p5Adapter(TimesFMConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultimodalDecoder(adapter)
    port = MultimodalDecoder(adapter, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Forecaster(port)
    with pytest.raises(NotImplementedError, match="sharded"):
        Forecaster(port, device="cpu", mesh=object())


def test_horizon_guard_and_quantile_head():
    port, _, _ = _pair()
    x = torch.zeros(2, 16)
    m = torch.zeros(2, 16, dtype=torch.bool)
    with pytest.raises(ValueError, match="output_patch_len"):
        port.forward_full(9, x, m)
    with pytest.raises(ValueError, match="use_quantile_head"):
        port.forward_quantiles(8, x, m)
    quant, jdec, jparams = _pair(use_quantile_head=True, quantile_horizon=16)
    ctx = np.random.default_rng(13).normal(size=(2, 16)).astype(np.float32)
    out = quant.forward_quantiles(12, torch.from_numpy(ctx), m)
    ref = jdec.forward_quantiles(jparams, 12, jnp.asarray(ctx), jnp.zeros((2, 16), bool))
    assert out.shape == (2, 12, 10)
    _assert_close(out.detach().numpy(), ref, "float32")


def test_bridge_is_strict():
    port, _, _ = _pair()
    tree = random_jax_params(port, 3)
    del tree["adapter"]["stacked_xf"]["attn"]["per_dim_scale"]
    with pytest.raises(ValueError, match="missing.*adapter/stacked_xf/attn/per_dim_scale"):
        load_jax_params(port, tree)
    tree = random_jax_params(port, 3)
    tree["fusion"]["layers"].append({"kernel": np.zeros((32, 32), np.float32)})
    with pytest.raises(ValueError, match="extra.*fusion/layers/1/kernel"):
        load_jax_params(port, tree)
    tree = random_jax_params(port, 3)
    tree["adapter"]["stacked_xf"]["ffn_up"]["kernel"] = np.zeros((2, 32, 33), np.float32)
    with pytest.raises(ValueError, match=r"adapter/stacked_xf/ffn_up/kernel: shape \(2, 32, 33\)"):
        load_jax_params(port, tree)


def test_bridge_lays_out_kernels_and_stacked_layers():
    port, _, _ = _pair()
    tree = random_jax_params(port, 4)
    load_jax_params(port, tree)
    layer1 = port.adapter.stacked_xf.layers[1]
    np.testing.assert_array_equal(
        layer1.attn.qkv.weight.detach().numpy(), tree["adapter"]["stacked_xf"]["attn"]["qkv"]["kernel"][1].T
    )
    np.testing.assert_array_equal(
        port.fusion.layers[0].weight.detach().numpy(), tree["fusion"]["layers"][0]["kernel"].T
    )
