"""PyTorch port vs the JAX package: the AOTInductor package of ``serving.export_program``.

One package is compiled for the module (TimesFM multimodal fp32, 2 layers,
on the CPU, where Inductor writes C++) and held to JAX's
``export_stablehlo``/``load_stablehlo`` on the same weights at batches 1, 3
and 7, at the fp32 tolerance of ``tests/test_torch_port_serving.py``
(2e-5 x std). The package calls the port's attention custom op through the
dispatcher and holds no weights; it refuses a device it was not compiled for;
and the export CLI writes one with ``--format aoti``.
"""

import json
import pickle
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.serving import export_stablehlo, load_stablehlo
from multimodal_timesfm_torch import serving
from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
from tests.test_torch_port_forecast import _pair as timesfm_pair
from tests.test_torch_port_serving import TEXT, _cli_inputs, _close


@pytest.fixture(scope="module")
def package(tmp_path_factory):
    """(the package's directory, the JAX StableHLO artifact's, the port decoder)."""
    root = tmp_path_factory.mktemp("aoti")
    port, jdec, tree = timesfm_pair(seed=1)
    art = serving.export_program(port, 8, 16, root / "aoti", multimodal=True, format="aoti")
    export_stablehlo(jdec, jax.tree.map(jnp.asarray, tree), horizon=8, context_len=16, output_dir=root / "hlo",
                     multimodal=True, platforms=("cpu",))
    return art, root / "hlo", port


def test_package_matches_jax_stablehlo(package):
    art, hlo, _ = package
    serve, manifest = serving.load_program(art, device="cpu")
    jserve, jmanifest = load_stablehlo(hlo)
    assert (manifest["format"], manifest["platforms"]) == ("aoti", ["cpu"])
    assert set(manifest) == set(jmanifest)
    assert not (art / "program.pt2").exists() and (art / "package.pt2").exists()
    rng = np.random.default_rng(2)
    for batch in (1, 3, 7):
        ctx = (rng.normal(size=(batch, 16)) * 3 + 10).astype(np.float32)
        txt = rng.normal(size=(batch, 4, TEXT)).astype(np.float32)
        out, ref = serve(ctx, txt), jserve(ctx, txt)
        assert set(out) == set(ref) == {"point_forecast"}
        _close(out["point_forecast"].numpy(), ref["point_forecast"])


def test_package_calls_the_kernel_op_and_holds_no_weights(package):
    """The compiled graph calls ``mtt::fused_causal_attention`` once per layer through the
    dispatcher (its proxy-executor nodes), and the package holds no constant: the weights
    stay in params.npz, which ``save_program_params`` re-points."""
    art, _, port = package
    with zipfile.ZipFile(art / "package.pt2") as z:
        nodes = [node for name in z.namelist() if name.endswith(".wrapper.json")
                 for node in json.loads(z.read(name))["nodes"]]
    targets = [node["node"]["target"] for node in nodes]
    assert targets == ["mtt::fused_causal_attention"] * port.adapter.config.num_layers, targets
    serving._register_ops()
    from torch._inductor import aoti_load_package

    assert aoti_load_package(str(art / "package.pt2")).get_constant_fqns() == []
    names = {name for name, _ in port.named_parameters()}
    with np.load(art / "params.npz") as npz:
        assert names <= set(npz.files)


def test_a_package_refuses_another_device_and_the_cli_refuses_another_format(package):
    art, _, port = package
    with pytest.raises(ValueError, match=r"compiled for \['cpu'\].*cuda"):
        serving.load_program(art, device="cuda")
    with pytest.raises(ValueError, match="unknown export format"):
        serving.export_program(port, 8, 16, art.parent / "x", multimodal=True, format="savedmodel")


def test_package_serves_repointed_weights_and_matches_the_eager_model(package, tmp_path):
    """``save_program_params`` re-points a package as it re-points a program; two loads of
    one package give bit-equal forecasts, within 2e-5 x std of the eager decoder."""
    art, _, _ = package
    copy = tmp_path / "copy"
    shutil.copytree(art, copy)
    other, _, _ = timesfm_pair(seed=1)
    load_jax_params(other, random_jax_params(other, 9))
    serving.save_program_params(copy, other)
    rng = np.random.default_rng(3)
    ctx = rng.normal(size=(5, 16)).astype(np.float32)
    txt = rng.normal(size=(5, 4, TEXT)).astype(np.float32)
    first = serving.load_program(copy, device="cpu")[0](ctx, txt)["point_forecast"]
    second = serving.load_program(copy, device="cpu")[0](ctx, txt)["point_forecast"]
    assert torch.equal(first, second)
    with torch.inference_mode():
        want = other(8, torch.from_numpy(ctx), torch.zeros(5, 16, dtype=torch.bool), torch.from_numpy(txt))
    _close(first.numpy(), want.numpy())
    before = serving.load_program(art, device="cpu")[0](ctx, txt)["point_forecast"]
    assert not torch.equal(before, first)


def test_export_cli_format_aoti_serves(tmp_path):
    from multimodal_timesfm_torch import export as tcli
    from multimodal_timesfm_torch import forecast as fcli

    model, snap, cache, ckpt = _cli_inputs(tmp_path)
    assert tcli.main(["--model-config", str(model), "--pretrained-dir", str(snap), "--fusion-checkpoint",
                      str(ckpt), "--context-len", "16", "--horizon", "8", "--multimodal", "--format", "aoti",
                      "--output", str(tmp_path / "art"), "--device", "cpu"]) == 0
    serve, manifest = serving.load_program(tmp_path / "art", device="cpu")
    assert manifest["format"] == "aoti"
    samples = pickle.loads(cache.read_bytes())
    ctx = np.stack([s["context"] for s in samples])
    txt = np.stack([s["text_embeddings"] for s in samples])
    assert fcli.main(["--cache-file", str(cache), "--model-config", str(model), "--pretrained-dir", str(snap),
                      "--checkpoint", str(ckpt), "--multimodal", "--horizon", "8", "--device", "cpu",
                      "--output", str(tmp_path / "f.npz")]) == 0
    _close(serve(ctx, txt)["point_forecast"].numpy(), np.load(tmp_path / "f.npz")["forecasts"])
