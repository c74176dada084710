"""PyTorch port vs the JAX package: the snapshot converters, ``from_pretrained``, safetensors.

Synthetic upstream state dicts come from ``tests/test_convert.py``'s
``_synthetic_state_dict`` (the rules' primary or alternate names), so the
port's ``convert_safetensors`` and JAX's see the same tensors. The trees are
compared leaf for leaf, bit-equal; forecasts after ``from_pretrained`` at the
fp32 tolerance of ``tests/test_torch_port_forecast.py`` (2e-5 x std). The
port's own safetensors reader is held to the ``safetensors`` package.
"""

import json
import logging
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import torch

from multimodal_timesfm_tpu.models import convert as jconvert
from multimodal_timesfm_tpu.models.chronos import Chronos2Adapter as JChronos
from multimodal_timesfm_tpu.models.chronos import Chronos2Config as JChronosConfig
from multimodal_timesfm_tpu.models.timesfm import TimesFM2p5Adapter as JTimesFM
from multimodal_timesfm_tpu.models.timesfm import TimesFMConfig as JTimesFMConfig
from multimodal_timesfm_torch.models import convert as tconvert
from multimodal_timesfm_torch.models.bridge import export_jax_params
from multimodal_timesfm_torch.models.chronos import Chronos2Adapter, Chronos2Config
from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
from multimodal_timesfm_torch.utils import safetensors as tst
from tests.test_convert import _synthetic_state_dict

STD_TOL = 2e-5

KINDS = {
    "timesfm": (TimesFM2p5Adapter, TimesFMConfig, JTimesFM, JTimesFMConfig, jconvert.TIMESFM_NAME_RULES),
    "chronos": (Chronos2Adapter, Chronos2Config, JChronos, JChronosConfig, jconvert.CHRONOS_NAME_RULES),
}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for key, value in items:
        out.update(_leaves(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _adapters(kind):
    cls, cfg, jcls, jcfg, rules = KINDS[kind]
    return cls(cfg.tiny()), jcls(jcfg.tiny()), rules


def _assert_trees_equal(ours, ref):
    ours, ref = _leaves(ours), _leaves(jax.device_get(ref))
    assert ours.keys() == ref.keys()
    for key in ref:
        assert ours[key].dtype == np.float32, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


@pytest.mark.parametrize("candidate", [0, 1, 2])
@pytest.mark.parametrize("kind", ["timesfm", "chronos"])
def test_converter_tree_is_bit_equal_to_jax(kind, candidate):
    """Primary names (0), the alternates (1, 2: split q/k/v, the other residual-block
    aliases), and the prefixed names: the same tree, leaf for leaf."""
    port, jad, rules = _adapters(kind)
    sd, _ = _synthetic_state_dict(jad, rules, candidate)
    _assert_trees_equal(tconvert.convert_safetensors(sd, port), jconvert.convert_safetensors(sd, jad))
    prefixed = {f"model.{k}": v for k, v in sd.items()}
    _assert_trees_equal(tconvert.convert_safetensors(prefixed, port),
                        jconvert.convert_safetensors(prefixed, jad))


@pytest.mark.parametrize("kind", ["timesfm", "chronos"])
def test_conversion_is_strict_like_jax(kind, caplog):
    port, jad, rules = _adapters(kind)
    sd, _ = _synthetic_state_dict(jad, rules)
    name = next(iter(sd))
    missing = {k: v for k, v in sd.items() if k != name}
    for conv, ad in ((tconvert, port), (jconvert, jad)):
        with pytest.raises(ValueError, match="unmatched template leaves"):
            conv.convert_safetensors(missing, ad)
    bad = dict(sd, **{name: np.zeros((3, 3), np.float32)})
    for conv, ad in ((tconvert, port), (jconvert, jad)):
        with pytest.raises(ValueError, match="checkpoint shape"):
            conv.convert_safetensors(bad, ad)
    extra = dict(sd, **{"unused.weight": np.zeros(2, np.float32)})
    with caplog.at_level(logging.WARNING):
        tconvert.convert_safetensors(extra, port)
    assert "not consumed" in caplog.text and "unused.weight" in caplog.text


@pytest.mark.parametrize("mean", [1.0, -2.0, 0.0])
def test_rms_convention_shift_matches_jax(mean, caplog):
    """A weight-convention RMS gain (mean above 0.5) is stored as weight - 1 and logged; a
    negative or zero-centred one is kept as it is."""
    port, jad, rules = _adapters("chronos")
    sd, _ = _synthetic_state_dict(jad, rules)
    name = "encoder.final_layer_norm.weight"
    sd[name] = (sd[name] * 0.01 + mean).astype(np.float32)
    with caplog.at_level(logging.INFO):
        ours = tconvert.convert_safetensors(sd, port)
    ref = jconvert.convert_safetensors(sd, jad)
    _assert_trees_equal(ours, ref)
    shifted = ours["encoder"]["final_norm"]["scale"]
    np.testing.assert_array_equal(shifted, sd[name] - 1.0 if mean > 0.5 else sd[name])
    assert ("weight-convention detected" in caplog.text) == (mean > 0.5)


def test_torch_bin_with_bf16_matches_jax(tmp_path):
    port, jad, rules = _adapters("timesfm")
    sd, _ = _synthetic_state_dict(jad, rules)
    torch.save({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()}, tmp_path / "pytorch_model.bin")
    ours = tconvert.load_backbone_checkpoint(tmp_path, port)
    _assert_trees_equal(ours, jconvert.load_backbone_checkpoint(tmp_path, jad))


def test_checkpoint_pickles_and_the_multimodal_refusal(tmp_path):
    """A pickled params tree (JAX's own, written by the JAX package) loads; a multimodal
    training checkpoint without backbone weights is refused with JAX's message."""
    import pickle

    port, jad, _ = _adapters("timesfm")
    params = jax.device_get(jad.init(jax.random.key(3)))
    with open(tmp_path / "adapter.ckpt", "wb") as f:
        pickle.dump({"adapter_params": params}, f)
    _assert_trees_equal(tconvert.load_backbone_checkpoint(tmp_path / "adapter.ckpt", port), params)
    with open(tmp_path / "fusion.pkl", "wb") as f:
        pickle.dump({"fusion_params": {}, "optimizer_state": ()}, f)
    with pytest.raises(ValueError, match="without backbone weights"):
        tconvert.load_backbone_checkpoint(tmp_path / "fusion.pkl", port)


@pytest.mark.parametrize("kind", ["timesfm", "chronos"])
def test_from_pretrained_forecasts_match_jax(kind, tmp_path):
    """A snapshot directory with config.json (a non-default geometry) and model.safetensors:
    the port's from_pretrained reads the geometry and the weights as JAX's does."""
    cls, cfg_cls, jcls, jcfg_cls, rules = KINDS[kind]
    if kind == "timesfm":
        hf = {"patch_len": 4, "output_patch_len": 8, "hidden_size": 32, "intermediate_size": 32,
              "num_hidden_layers": 3, "num_attention_heads": 2}
    else:
        hf = {"chronos_config": {"input_patch_size": 4, "output_patch_size": 4, "max_output_patches": 4},
              "d_model": 32, "num_layers": 3, "num_heads": 2, "d_ff": 64}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    jad_template = jcls(jcls.config_from_hf(hf))
    sd, _ = _synthetic_state_dict(jad_template, rules)
    sd = {k: (0.2 * v).astype(np.float32) for k, v in sd.items()}
    tst.save_file(sd, tmp_path / "model.safetensors")
    port = cls.from_pretrained(tmp_path)
    jad, jparams = jcls.from_pretrained(str(tmp_path))
    assert port.config.num_layers == 3 and port.patch_len == 4
    _assert_trees_equal(export_jax_params(port), jparams)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 16)) + 5).astype(np.float32)
    m = np.zeros_like(x, bool)
    pre = jad.preprocess(jparams, jnp.asarray(x), jnp.asarray(m))
    ref = np.asarray(jad.postprocess(jparams, 8, jad.forward(jparams, pre.input_embeddings, pre.masks),
                                     pre.normalization_stats))
    with torch.inference_mode():
        tpre = port.preprocess(torch.from_numpy(x), torch.from_numpy(m))
        out = port.postprocess(8, port(tpre.input_embeddings, tpre.masks), tpre.normalization_stats)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=STD_TOL * ref.std())


def test_safetensors_reader_matches_the_package(tmp_path):
    """F32, F16, BF16, I64 and I32 as the package writes them; the package reads the
    port's writer's files back bit-equal."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "f16": rng.normal(size=(7,)).astype(np.float16),
        "bf16": rng.normal(size=(2, 3, 4)).astype(ml_dtypes.bfloat16),
        "i64": rng.integers(-9, 9, size=(4, 2)).astype(np.int64),
        "i32": rng.integers(-9, 9, size=(6,)).astype(np.int32),
        "scalar": np.array(2.5, np.float32),
    }
    safetensors.numpy.save_file(arrays, str(tmp_path / "pkg.safetensors"), metadata={"a": "b"})
    ours = tst.load_file(tmp_path / "pkg.safetensors")
    assert ours["bf16"].dtype == torch.bfloat16
    for name, ref in arrays.items():
        got = ours[name].float().numpy() if name == "bf16" else ours[name].numpy()
        np.testing.assert_array_equal(got, ref.astype(np.float32) if name == "bf16" else ref)
        assert got.shape == ref.shape
    tst.save_file(ours, tmp_path / "port.safetensors")
    back = safetensors.numpy.load_file(str(tmp_path / "port.safetensors"))
    for name, ref in arrays.items():
        assert back[name].dtype == ref.dtype
        np.testing.assert_array_equal(back[name], ref)


def _header_file(path, header, body=b"", length=None):
    text = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(text) if length is None else length) + text + body)
    return path


@pytest.mark.parametrize("case", ["length past the end", "offset out of range", "unknown dtype",
                                  "size mismatch", "not json", "too short"])
def test_safetensors_reader_refuses_malformed_files(tmp_path, case):
    path = tmp_path / "bad.safetensors"
    ok = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    if case == "length past the end":
        _header_file(path, {"a": ok}, b"\0" * 8, length=1 << 20)
        match = "runs past the end"
    elif case == "offset out of range":
        _header_file(path, {"a": dict(ok, data_offsets=[0, 16])}, b"\0" * 8)
        match = "outside the"
    elif case == "unknown dtype":
        _header_file(path, {"a": dict(ok, dtype="F64")}, b"\0" * 8)
        match = "dtype 'F64'"
    elif case == "size mismatch":
        _header_file(path, {"a": dict(ok, shape=[3])}, b"\0" * 8)
        match = "spans 8 bytes"
    elif case == "not json":
        path.write_bytes(struct.pack("<Q", 4) + b"{{{{")
        match = "not JSON"
    else:
        path.write_bytes(b"\0\0")
        match = "too short"
    with pytest.raises(ValueError, match=match) as info:
        tst.load_file(path)
    assert str(path) in str(info.value)


def test_the_converters_need_no_safetensors_package(tmp_path, monkeypatch):
    """models/convert.py and text/convert.py read model.safetensors with the port's reader."""
    import sys

    from multimodal_timesfm_torch.text import convert as text_convert

    port, jad, rules = _adapters("chronos")
    sd, _ = _synthetic_state_dict(jad, rules)
    tst.save_file(sd, tmp_path / "model.safetensors")
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    tree = tconvert.load_backbone_checkpoint(tmp_path, port)
    assert tree["shared"].shape == (2, 32)
    loaded = text_convert.load_state_dict(tmp_path)
    np.testing.assert_array_equal(loaded["shared.weight"], sd["shared.weight"])
