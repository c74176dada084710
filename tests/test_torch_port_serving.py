"""PyTorch port vs the JAX package: the exported artifact, the decode graph, the two CLIs.

``serving.export_program``/``load_program`` are held to JAX's
``export_stablehlo``/``load_stablehlo`` on the same weights (a numpy tree
loaded into both) at the fp32 tolerance of ``tests/test_torch_port_forecast.py``
(2e-5 x std). The forecast CLI is held to ``scripts/forecast.py`` run
in-process on one synthetic cache, snapshot and JAX-written checkpoint.
"""

import dataclasses
import json
import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.inference import Forecaster as JForecaster
from multimodal_timesfm_tpu.models.convert import TIMESFM_NAME_RULES
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoder as JDecoder
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoderConfig as JDecoderConfig
from multimodal_timesfm_tpu.models.timesfm import TimesFM2p5Adapter as JAdapter
from multimodal_timesfm_tpu.models.timesfm import TimesFMConfig as JConfig
from multimodal_timesfm_tpu.serving import export_stablehlo, load_stablehlo
from multimodal_timesfm_tpu.training.trainer import MultimodalTrainer as JTrainer
from multimodal_timesfm_tpu.training_args import TrainingArguments as JArgs
from multimodal_timesfm_torch import serving
from multimodal_timesfm_torch.inference import Forecaster
from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
from multimodal_timesfm_torch.utils import safetensors as tst
from tests.test_convert import _synthetic_state_dict
from tests.test_torch_port_chronos import _pair as chronos_pair
from tests.test_torch_port_forecast import _pair as timesfm_pair

REPO = Path(__file__).resolve().parent.parent
STD_TOL = 2e-5
TEXT = 6


def _close(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=STD_TOL * ref.std())


CASES = {
    "timesfm multimodal full": ("timesfm", True, True),
    "timesfm unimodal": ("timesfm", False, False),
    "chronos quantiles": ("chronos", True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_exported_program_matches_jax_stablehlo(tmp_path, case):
    """One artifact each, served at batches 1, 3 and 7; the graph holds the port's custom
    ops and no weights (the program stays small)."""
    kind, multimodal, full = CASES[case]
    port, jdec, tree = (timesfm_pair if kind == "timesfm" else chronos_pair)(seed=1)
    jparams = jax.tree.map(jnp.asarray, tree)
    art = serving.export_program(port, 8, 16, tmp_path / "pt", multimodal=multimodal, full_outputs=full)
    export_stablehlo(jdec, jparams, horizon=8, context_len=16, output_dir=tmp_path / "hlo",
                     multimodal=multimodal, full_outputs=full, platforms=("cpu",))
    serve, manifest = serving.load_program(art, device="cpu")
    jserve, jmanifest = load_stablehlo(tmp_path / "hlo")
    assert manifest["format"] == "torch.export"
    assert set(manifest) == set(jmanifest)
    assert {k: manifest[k] for k in ("horizon", "context_len", "num_patches", "text_dims", "multimodal",
                                     "full_outputs")} == {k: jmanifest[k] for k in ("horizon", "context_len",
                                     "num_patches", "text_dims", "multimodal", "full_outputs")}
    rng = np.random.default_rng(2)
    for batch in (1, 3, 7):
        ctx = (rng.normal(size=(batch, 16)) * 3 + 10).astype(np.float32)
        txt = rng.normal(size=(batch, 4, TEXT)).astype(np.float32)
        out = serve(ctx, txt) if multimodal else serve(ctx)
        ref = jserve(ctx, txt) if multimodal else jserve(ctx)
        assert set(out) == set(ref)
        for name in ref:
            _close(out[name].numpy(), ref[name])
    program = torch.export.load(art / "program.pt2")
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    want = "mtt.fused_chronos_attention.default" if kind == "chronos" else "mtt.fused_causal_attention.default"
    assert want in ops, sorted(ops)
    # No weights in the program: no parameters, no example inputs, constants of a few elements.
    assert not program.state_dict and program.example_inputs is None
    assert sum(t.numel() for t in program.constants.values()) < 16


def test_repointing_checks_the_spec_first_and_writes_atomically(tmp_path):
    port, _, tree = timesfm_pair(seed=3)
    art = serving.export_program(port, 8, 16, tmp_path / "pt", multimodal=True)
    ctx = np.random.default_rng(4).normal(size=(3, 16)).astype(np.float32)
    txt = np.random.default_rng(5).normal(size=(3, 4, TEXT)).astype(np.float32)
    before = serving.load_program(art, device="cpu")[0](ctx, txt)["point_forecast"]
    wide, _, _ = timesfm_pair(seed=3, num_layers=3)
    with pytest.raises(ValueError, match="do not match the exported"):
        serving.save_program_params(art, wide)
    assert not list(art.glob("*.tmp"))
    same = serving.load_program(art, device="cpu")[0](ctx, txt)["point_forecast"]
    assert torch.equal(before, same)
    load_jax_params(port, random_jax_params(port, 9))  # a "fine-tune"
    serving.save_program_params(art, port)
    assert not list(art.glob("*.tmp"))
    after = serving.load_program(art, device="cpu")[0](ctx, txt)["point_forecast"]
    with torch.inference_mode():
        want = port(8, torch.from_numpy(ctx), torch.zeros(3, 16, dtype=torch.bool), torch.from_numpy(txt))
    assert not torch.equal(after, before)
    assert torch.equal(after, want)  # the same aten ops on the same weights


_BLOCKED_LOAD = """
import sys
import numpy as np
for name in ("jax", "jaxlib", "multimodal_timesfm_tpu", "multimodal_timesfm_torch.models", "examples"):
    sys.modules[name] = None
from multimodal_timesfm_torch.serving import load_program
art, data = sys.argv[1:3]
ref = np.load(data)
serve, manifest = load_program(art, device="cpu")
out = serve(ref["context"], ref["text"])["point_forecast"].numpy()
assert np.abs(out - ref["want"]).max() <= 2e-5 * ref["want"].std(), np.abs(out - ref["want"]).max()
assert "multimodal_timesfm_torch.models.decoder" not in sys.modules
print("served", out.shape)
"""


def test_load_program_serves_without_jax_or_the_model_code(tmp_path):
    port, _, _ = chronos_pair(seed=6)
    art = serving.export_program(port, 8, 16, tmp_path / "pt", multimodal=True)
    rng = np.random.default_rng(7)
    ctx = rng.normal(size=(5, 16)).astype(np.float32)
    txt = rng.normal(size=(5, 4, TEXT)).astype(np.float32)
    with torch.inference_mode():
        want = port(8, torch.from_numpy(ctx), torch.zeros(5, 16, dtype=torch.bool), torch.from_numpy(txt))
    np.savez(tmp_path / "data.npz", context=ctx, text=txt, want=want.numpy())
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_LOAD, str(art), str(tmp_path / "data.npz")],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "served (5, 8)" in proc.stdout


def test_decode_matches_jax_fused_ar_and_the_host_loop():
    """tests/test_inference.py's case: horizon 20 in chunks of 8, text on the first window."""
    port, jdec, tree = timesfm_pair(seed=0)
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(11)
    ctx = rng.normal(size=(3, 16)).astype(np.float32)
    text = rng.normal(size=(3, 4, TEXT)).astype(np.float32)
    pf = Forecaster(port, batch_size=4, device="cpu")
    jf = JForecaster(jdec, jparams, batch_size=4)
    c, m, outs, remaining, first = ctx.copy(), np.zeros_like(ctx, bool), [], 20, True
    while remaining > 0:
        emit = min(8, remaining)
        preds = pf.forecast(8, c, m, text if first else None)
        outs.append(preds[:, :emit])
        c = np.concatenate([c[:, 8:], preds.astype(np.float32)], axis=1)
        m = np.concatenate([m[:, 8:], np.zeros_like(preds, bool)], axis=1)
        remaining -= emit
        first = False
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = pf.forecast_autoregressive(20, ctx, text_embeddings=text)
        ref = jf.forecast_autoregressive(20, ctx, text_embeddings=text)
    np.testing.assert_array_equal(got, np.concatenate(outs, axis=1))
    _close(got, ref)


def test_decode_graph_cache_is_bounded(monkeypatch):
    """As tests/test_inference.py's fn caches: caller-controlled horizons give at most 8
    decode graphs (graphs stand in as eager decodes here; the card captures them)."""
    port, _, _ = timesfm_pair(seed=0)
    pf = Forecaster(port, batch_size=2, device="cpu")
    pf._use_graphs = True
    built = []
    monkeypatch.setattr(pf, "_graph_runner", lambda eager: built.append(1) or eager)
    ctx = np.random.default_rng(12).normal(size=(2, 16)).astype(np.float32)
    for rounds in range(1, 11):
        out = pf.forecast_autoregressive(8 * rounds, ctx)
        assert out.shape == (2, 8 * rounds)
    assert len(built) == 10 and len(pf._ar_graphs) == pf._fn_cache_max == 8
    pf.forecast_autoregressive(80, ctx)  # a hit: nothing built
    assert len(built) == 10



def _static_buffer_runner(built):
    """A stand-in for ``Forecaster._graph_runner`` that keeps its inputs as static buffers
    as a captured graph does: a later call of another shape fails in ``copy_``."""

    def runner(eager):
        built.append(1)
        bufs = []

        def run(ctx, msk, text):
            if not bufs:
                bufs.extend(None if t is None else t.clone() for t in (ctx, msk, text))
            else:
                for buf, value in zip(bufs, (ctx, msk, text)):
                    if buf is not None:
                        buf.copy_(value)
            return eager(*bufs)

        return run

    return runner


def test_decode_graph_is_keyed_by_every_input_shape(monkeypatch):
    """One Forecaster decodes at two context lengths, with text of two patch counts: each
    shape gets its own graph, and a repeated shape replays the one it built."""
    port, _, _ = timesfm_pair(seed=0)
    pf = Forecaster(port, batch_size=2, device="cpu")
    pf._use_graphs = True
    built = []
    monkeypatch.setattr(pf, "_graph_runner", _static_buffer_runner(built))
    rng = np.random.default_rng(13)
    eager = Forecaster(port, batch_size=2, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for length in (16, 24, 16):
            ctx = rng.normal(size=(2, length)).astype(np.float32)
            text = rng.normal(size=(2, length // 4, TEXT)).astype(np.float32)
            for t in (None, text):
                out = pf.forecast_autoregressive(16, ctx, text_embeddings=t)
                np.testing.assert_array_equal(out, eager.forecast_autoregressive(16, ctx, text_embeddings=t))
    assert len(built) == len(pf._ar_graphs) == 4


def _cli_inputs(tmp_path):
    """A model config (JSON, which both packages' readers take), a TimesFM snapshot with
    config.json, a cache of 6 samples and a JAX-written multimodal checkpoint."""
    arch = {"input_patch_len": 4, "output_patch_len": 8, "model_dims": 32, "ffn_dims": 32, "num_heads": 2}
    (tmp_path / "model.json").write_text(json.dumps({
        "adapter": {"type": "timesfm", "patch_len": 4, "arch": arch},
        "fusion": {"text_embedding_dims": TEXT},
    }))
    snap = tmp_path / "snapshot"
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps({"num_hidden_layers": 2, "hidden_size": 64}))
    jad = JAdapter(dataclasses.replace(JConfig.tiny(), **arch))
    sd, _ = _synthetic_state_dict(jad, TIMESFM_NAME_RULES)
    tst.save_file({k: (0.2 * v).astype(np.float32) for k, v in sd.items()}, snap / "model.safetensors")
    rng = np.random.default_rng(13)
    samples = [{
        "context": rng.normal(size=16).astype(np.float32),
        "horizon": rng.normal(size=8).astype(np.float32),
        "text_embeddings": rng.normal(size=(4, TEXT)).astype(np.float32),
        "metadata": {"mean": float(rng.normal()), "std": float(rng.uniform(0.5, 2)), "domain": "D", "i": i},
    } for i in range(6)]
    cache = tmp_path / "cache" / "time_mmd_D_english_p4_c16_h8.pkl"
    cache.parent.mkdir()
    cache.write_bytes(pickle.dumps(samples))
    jdec = JDecoder(jad, JDecoderConfig(text_embedding_dims=TEXT))
    args = JArgs(output_dir=str(tmp_path / "jtrain"), per_device_train_batch_size=4, num_train_epochs=1,
                 eval_strategy="epoch", save_strategy="epoch", logging_strategy="no", seed=0,
                 learning_rate=1e-2)
    trainer = JTrainer(jdec, jdec.init(jax.random.key(1)), args, samples, samples, "multimodal", fuse_epochs=False)
    trainer.train()
    return tmp_path / "model.json", snap, cache, args.checkpoint_dir / "checkpoint_epoch_0.ckpt"


@pytest.mark.parametrize("mode", ["single shot", "autoregressive"])
def test_forecast_cli_matches_the_jax_script(tmp_path, monkeypatch, mode):
    import scripts.forecast as jcli

    from multimodal_timesfm_torch import forecast as tcli

    model, snap, cache, ckpt = _cli_inputs(tmp_path)
    flags = ["--cache-file", str(cache), "--model-config", str(model), "--pretrained-dir", str(snap),
             "--checkpoint", str(ckpt), "--multimodal", "--denormalize", "--batch-size", "4"]
    flags += ["--horizon", "20", "--autoregressive"] if mode == "autoregressive" else ["--horizon", "8"]
    monkeypatch.setattr(sys, "argv", ["forecast.py", *flags, "--output", str(tmp_path / "jax.npz")])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert jcli.main() == 0
        assert tcli.main([*flags, "--output", str(tmp_path / "port.npz"), "--device", "cpu"]) == 0
    ours, ref = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert set(ours.files) == set(ref.files) == {"forecasts", "metadata"}
    np.testing.assert_array_equal(ours["metadata"], ref["metadata"])
    _close(ours["forecasts"], ref["forecasts"])


def test_export_cli_writes_an_artifact_that_serves(tmp_path):
    from multimodal_timesfm_torch import export as tcli

    model, snap, cache, ckpt = _cli_inputs(tmp_path)
    assert tcli.main(["--model-config", str(model), "--pretrained-dir", str(snap), "--fusion-checkpoint",
                      str(ckpt), "--context-len", "16", "--horizon", "8", "--multimodal", "--output",
                      str(tmp_path / "art"), "--device", "cpu"]) == 0
    serve, manifest = serving.load_program(tmp_path / "art", device="cpu")
    samples = pickle.loads(cache.read_bytes())
    ctx = np.stack([s["context"] for s in samples])
    txt = np.stack([s["text_embeddings"] for s in samples])
    from multimodal_timesfm_torch import forecast as fcli

    assert fcli.main(["--cache-file", str(cache), "--model-config", str(model), "--pretrained-dir", str(snap),
                      "--checkpoint", str(ckpt), "--multimodal", "--horizon", "8", "--device", "cpu",
                      "--output", str(tmp_path / "f.npz")]) == 0
    _close(serve(ctx, txt)["point_forecast"].numpy(), np.load(tmp_path / "f.npz")["forecasts"])
    with pytest.raises(SystemExit):
        tcli.main(["--output", str(tmp_path / "x"), "--format", "stablehlo"])


@pytest.mark.parametrize("case", ["chronos packed 2 per row", "timesfm bf16-stored folded"])
def test_export_of_packed_and_bf16_stored_models(tmp_path, case):
    """A Chronos-2 that packs series per encoder row is traced unpacked (numerically the
    same), so any batch serves; a frozen TimesFM as the trainer holds it (affine fold, bf16
    weights, bf16 compute: the bf16 GEMMs of ``_DenseBf16``) exports and serves."""
    from multimodal_timesfm_torch.models.layers import fold_frozen_tree_affines

    if case.startswith("chronos"):
        port, _, _ = chronos_pair(seed=8, pack=2)
    else:
        port, _, _ = timesfm_pair("bfloat16", seed=8)
        fold_frozen_tree_affines(port.adapter)
        for p in port.adapter.parameters():
            p.data = p.data.to(torch.bfloat16)
    serve, _ = serving.load_program(serving.export_program(port, 8, 16, tmp_path / "pt", multimodal=True),
                                    device="cpu")
    rng = np.random.default_rng(9)
    if case.startswith("chronos"):  # a batch the packed module would refuse
        assert serve(np.zeros((3, 16), np.float32), np.zeros((3, 4, TEXT), np.float32))["point_forecast"].shape == (3, 8)
    for batch in (2, 4):
        ctx = rng.normal(size=(batch, 16)).astype(np.float32)
        txt = rng.normal(size=(batch, 4, TEXT)).astype(np.float32)
        with torch.inference_mode():
            want = port(8, torch.from_numpy(ctx), torch.zeros(batch, 16, dtype=torch.bool), torch.from_numpy(txt))
        _close(serve(ctx, txt)["point_forecast"].numpy(), want.numpy())
