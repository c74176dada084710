"""PyTorch port vs the JAX package: tokenizers, the BERT and ModernBERT encoders, the
snapshot converters and config readers, the bridge over the encoders' trees.

Both packages get the same numpy-seeded inputs and, for the encoders, the same
parameters: trees of the JAX package's ``init_bert`` / ``init_modernbert``
layout drawn with numpy, loaded into the port through ``models/bridge.py``. Everything runs on the CPU in
fp32. Encoder tolerance: ``ENC_ATOL`` on L2-normalised embeddings (measured
about 1e-7: the same fp32 ops, summed in another order).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.models import snapshot as jsnap
from multimodal_timesfm_tpu.text import bert as jbert
from multimodal_timesfm_tpu.text import convert as jconvert
from multimodal_timesfm_tpu.text import modernbert as jmodern
from multimodal_timesfm_tpu.text import tokenizer as jtok
from multimodal_timesfm_tpu.text.encoders import EnglishTextEncoder as JEnglish
from multimodal_timesfm_torch.models import snapshot as tsnap
from multimodal_timesfm_torch.models.bridge import export_jax_params, load_jax_params
from multimodal_timesfm_torch.text import bert as tbert
from multimodal_timesfm_torch.text import convert as tconvert
from multimodal_timesfm_torch.text import modernbert as tmodern
from multimodal_timesfm_torch.text import native as tnative
from multimodal_timesfm_torch.text import tokenizer as ttok
from multimodal_timesfm_torch.text.encoders import build_text_encoder, fp32_matmuls

ENC_ATOL = 1e-5

VOCAB = (
    "[PAD] [UNK] [CLS] [SEP] [MASK] the quick brown fox jump ##s over lazy dog "
    "report prediction search energy price ##d cafe , . ! un ##known".split()
)
# The JAX tests' texts, plus texts long enough for every length bucket and for
# truncation at 256 and at a short max_length.
TEXTS = [
    "The quick brown fox jumps over the lazy dog",
    "Report: energy priced, searched!",
    "unknown unknowable",
    "",
    "  spaces   and, punctuation! ",
    "CAFE Café café",
    "Āłstraße",
    "a" * 150,
    "NUL\x00inside",
    *[" ".join(["the quick fox jumps"] * n) for n in (5, 9, 20, 40, 80)],
]


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


def _jax_tree(init, cfg, seed):
    """A params tree of the structure and shapes of JAX's ``init(key, cfg)`` (read with
    ``jax.eval_shape``, without running the init), drawn with numpy: kernels and tables
    N(0, 0.3^2), norm gains 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1.0 + rng.normal(0.0, 0.1, leaf.shape)).astype(np.float32)
        return rng.normal(0.0, 0.1 if "bias" in name else 0.3, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0)))


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    return path


@pytest.fixture(scope="module")
def bert_snapshot(tmp_path_factory):
    """A tiny BERT snapshot: config.json, vocab.txt and model.safetensors under HF's names,
    drawn with numpy (with the pooler and position_ids an HF snapshot also holds)."""
    from safetensors.numpy import save_file

    cfg = dataclasses.replace(tbert.BertConfig.tiny(), vocab_size=len(VOCAB))
    snap = tmp_path_factory.mktemp("minilm")
    rng = np.random.default_rng(11)
    module = tbert.BertEncoder(cfg)
    sd = {
        name: rng.normal(0.0, 0.5, leaf.shape).astype(np.float32)
        for name, leaf in tconvert.hf_bert_state(export_jax_params(module)).items()
    }
    sd["pooler.dense.weight"] = np.zeros((cfg.hidden_size, cfg.hidden_size), np.float32)
    sd["embeddings.position_ids"] = np.arange(cfg.max_position_embeddings, dtype=np.int64)[None]
    save_file(sd, str(snap / "model.safetensors"))
    (snap / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    (snap / "config.json").write_text(json.dumps({
        "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.intermediate_size,
        "vocab_size": cfg.vocab_size, "max_position_embeddings": cfg.max_position_embeddings,
    }))
    return snap, sd


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------


def _tokenizers(kind, vocab_file):
    if kind == "hash":
        return ttok.HashTokenizer(1000), jtok.HashTokenizer(1000)
    native = kind == "native"
    port = ttok.WordPieceTokenizer(vocab_file, use_native=native)
    assert (port._native is not None) == native, "the port's native WordPiece did not build"
    return port, jtok.WordPieceTokenizer(vocab_file, use_native=False)


@pytest.mark.parametrize("kind", ["python", "native", "hash"])
def test_tokenizer_matches_jax(vocab_file, kind):
    """The same ids per text, and the same padded (ids, mask) batches: buckets 16 to 512,
    truncation at 256 and at max_length 20."""
    port, ref = _tokenizers(kind, vocab_file)
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text), repr(text)
    for max_length in (256, 20, 512):
        for lo, hi in ((0, 4), (9, 11), (9, 12), (9, 13), (9, 14)):
            ours = port.encode_batch(TEXTS[lo:hi], max_length)
            theirs = ref.encode_batch(TEXTS[lo:hi], max_length)
            for o, t in zip(ours, theirs):
                assert o.dtype == t.dtype == np.int32
                np.testing.assert_array_equal(o, t)
    seqs = {port.encode_batch([t])[0].shape[1] for t in TEXTS}
    assert {16, 64, 128, 256} <= seqs if kind != "hash" else {16, 32, 64, 128} <= seqs


def test_native_library_builds_outside_the_source_tree():
    """The port's copy of the C++ source differs from the JAX package's in comments only,
    and builds under build/torch_kernels/, not beside either source."""
    def code(path):
        return [line for line in path.read_text().splitlines() if not line.lstrip().startswith("//")]

    assert code(tnative.SOURCE) == code(tnative._PKG.parent / "csrc" / "wordpiece.cpp")
    assert tnative.load_library() is not None
    lib_path = tnative.library_path()
    assert lib_path.parent == tnative.BUILD_DIR and lib_path.exists()


# ---------------------------------------------------------------------------
# encoders on bridged params
# ---------------------------------------------------------------------------


def _ids_and_mask(vocab, batch=3, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    mask[1, 10:] = 0
    mask[2, 3:] = 0
    return ids, mask


def test_bert_matches_jax_on_bridged_params():
    cfg = jbert.BertConfig.tiny()
    tree = _jax_tree(jbert.init_bert, cfg, 1)
    module = tbert.BertEncoder(tbert.BertConfig.tiny())
    load_jax_params(module, tree)
    ids, mask = _ids_and_mask(cfg.vocab_size)
    ref = np.asarray(jbert.bert_encode_jit(tree, cfg, jnp.asarray(ids), jnp.asarray(mask)))
    out = module(torch.from_numpy(ids), torch.from_numpy(mask)).detach().numpy()
    assert out.shape == (3, cfg.hidden_size)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ENC_ATOL)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_modernbert_matches_jax_on_bridged_params(pooling):
    """Four layers: 0 and 3 global, 1 and 2 local with window 4 over 16 tokens, so the
    window masks keys a global layer sees."""
    cfg = dataclasses.replace(jmodern.ModernBertConfig.tiny(), pooling=pooling)
    tree = _jax_tree(jmodern.init_modernbert, cfg, 2)
    module = tmodern.ModernBertEncoder(dataclasses.replace(tmodern.ModernBertConfig.tiny(), pooling=pooling))
    load_jax_params(module, tree)
    assert [layer.is_global for layer in module.layers] == [True, False, False, True]
    ids, mask = _ids_and_mask(cfg.vocab_size, seed=1)
    ref = np.asarray(jmodern.modernbert_encode_jit(tree, cfg, jnp.asarray(ids), jnp.asarray(mask)))
    out = module(torch.from_numpy(ids), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ENC_ATOL)
    # The window matters: all-global attention gives other embeddings.
    wide = tmodern.ModernBertEncoder(dataclasses.replace(module.config, local_attention_window=64))
    load_jax_params(wide, tree)
    assert np.abs(wide(torch.from_numpy(ids), torch.from_numpy(mask)).detach().numpy() - out).max() > 1e-4


def test_rope_tables_match_jax():
    """RoPE angles in fp32 as JAX forms them, at the global and local thetas, against
    JAX's ``_rope`` run op by op: measured 2.4e-7 (one rounding of a sin or cos), held to
    1e-6. (JAX's own jitted ``_rope`` differs from its op-by-op form by 2.3e-6 here: XLA
    fuses the angle into its sin and cos.)"""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, 3, 64)).astype(np.float32)
    for theta in (160000.0, 10000.0):
        ref = np.asarray(jmodern._rope(jnp.asarray(x), theta))
        cos, sin = tmodern.rope_tables(40, 64, theta, torch.device("cpu"))
        out = tmodern.apply_rope(torch.from_numpy(x), cos, sin).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("encoder", ["bert", "modernbert"])
def test_bool_attention_mask_is_refused(encoder):
    module = tbert.BertEncoder(tbert.BertConfig.tiny()) if encoder == "bert" else (
        tmodern.ModernBertEncoder(tmodern.ModernBertConfig.tiny()))
    ids = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(TypeError, match="HF polarity"):
        module(ids, torch.ones(1, 4, dtype=torch.bool))


@pytest.mark.parametrize("encoder", ["bert", "modernbert"])
def test_bridge_round_trip_of_an_encoder_tree_is_strict(encoder):
    """JAX tree -> module -> tree is bit-equal; a missing, extra or misshapen leaf raises."""
    if encoder == "bert":
        tree = _jax_tree(jbert.init_bert, jbert.BertConfig.tiny(), 4)
        module = tbert.BertEncoder(tbert.BertConfig.tiny())
    else:
        tree = _jax_tree(jmodern.init_modernbert, jmodern.ModernBertConfig.tiny(), 5)
        module = tmodern.ModernBertEncoder(tmodern.ModernBertConfig.tiny())
        assert "attn_norm" not in tree["layers"][0] and "attn_norm" in tree["layers"][1]
    load_jax_params(module, tree)
    back = export_jax_params(module)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for key, leaf in _leaves(tree).items():
        np.testing.assert_array_equal(_leaves(back)[key], leaf, err_msg=key)

    missing = jax.tree.map(lambda a: a, tree)
    del missing["layers"][1]["wo" if encoder == "modernbert" else "q"]
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(module, missing)
    extra = jax.tree.map(lambda a: a, tree)
    extra["layers"][0]["attn_norm" if encoder == "modernbert" else "extra"] = {"scale": np.ones(16, np.float32)}
    with pytest.raises(ValueError, match="extra"):
        load_jax_params(module, extra)
    bad = jax.tree.map(lambda a: a, tree)
    bad["embeddings"]["word"] = bad["embeddings"]["word"][:-1]
    with pytest.raises(ValueError, match="embeddings/word: shape"):
        load_jax_params(module, bad)


# ---------------------------------------------------------------------------
# converters, snapshots and the encoders' call contract
# ---------------------------------------------------------------------------


def test_load_hf_bert_matches_jax(bert_snapshot, tmp_path):
    snap, sd = bert_snapshot
    cfg = tsnap.bert_config_from_hf(tsnap.read_hf_config(snap))
    tree, tok = tconvert.load_hf_bert(snap, cfg)
    jtree, jtokenizer = jconvert.load_hf_bert(snap, jsnap.bert_config_from_hf(jsnap.read_hf_config(snap)))
    ours, ref = _leaves(tree), _leaves(jtree)
    assert ours.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    assert [tok.encode(t) for t in TEXTS] == [jtokenizer.encode(t) for t in TEXTS]
    # The inverse writes the snapshot's own names back.
    back = tconvert.hf_bert_state(tree)
    assert back.keys() == set(sd) - {"pooler.dense.weight", "embeddings.position_ids"}
    for key in back:
        np.testing.assert_array_equal(back[key], sd[key], err_msg=key)

    # pytorch_model.bin (no safetensors needed) reads the same tree.
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, bin_dir / "pytorch_model.bin")
    for key, leaf in _leaves(tconvert.convert_hf_bert_state(tconvert.load_state_dict(bin_dir), cfg)).items():
        np.testing.assert_array_equal(leaf, ref[key], err_msg=key)

    # Strict: a missing key names itself; a misshapen one fails the load into the module.
    short = {k: v for k, v in sd.items() if k != "encoder.layer.1.output.dense.bias"}
    with pytest.raises(KeyError, match="encoder.layer.1.output.dense.bias"):
        tconvert.convert_hf_bert_state(short, cfg)
    wrong = dict(sd, **{"encoder.layer.0.attention.self.query.weight": np.zeros((16, 8), np.float32)})
    with pytest.raises(ValueError, match="layers/0/q/kernel: shape"):
        load_jax_params(tbert.BertEncoder(cfg), tconvert.convert_hf_bert_state(wrong, cfg))


def test_convert_hf_modernbert_state_matches_jax(tmp_path):
    """A synthetic HF ModernBERT snapshot (model.safetensors, with the "model." prefix and a
    head the tree does not use) converts to the same tree in both packages."""
    from safetensors.numpy import save_file

    cfg = tmodern.ModernBertConfig.tiny()
    rng = np.random.default_rng(6)
    module = tmodern.ModernBertEncoder(cfg)
    sd = {"model.embeddings.tok_embeddings.weight": rng.normal(size=(128, 16)),
          "model.embeddings.norm.weight": rng.normal(size=16),
          "model.final_norm.weight": rng.normal(size=16), "head.dense.weight": rng.normal(size=(16, 16))}
    names = {"wqkv": "attn.Wqkv", "wo": "attn.Wo", "mlp_wi": "mlp.Wi", "mlp_wo": "mlp.Wo"}
    for i, layer in enumerate(module.layers):
        for attr, name in names.items():
            sd[f"model.layers.{i}.{name}.weight"] = rng.normal(size=getattr(layer, attr).weight.shape)
        sd[f"model.layers.{i}.mlp_norm.weight"] = rng.normal(size=16)
        if i > 0:
            sd[f"model.layers.{i}.attn_norm.weight"] = rng.normal(size=16)
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    save_file(sd, str(tmp_path / "model.safetensors"))
    ours = tmodern.convert_hf_modernbert_state(tconvert.load_state_dict(tmp_path), cfg)
    ref = jmodern.convert_hf_modernbert_state(sd, jmodern.ModernBertConfig.tiny())
    assert _leaves(ours).keys() == _leaves(ref).keys()
    for key, leaf in _leaves(ref).items():
        np.testing.assert_array_equal(_leaves(ours)[key], leaf, err_msg=key)
    load_jax_params(module, ours)  # the converted tree fits the module
    with pytest.raises(KeyError, match="layers.2.attn_norm.weight"):
        tmodern.convert_hf_modernbert_state(
            {k: v for k, v in sd.items() if k != "model.layers.2.attn_norm.weight"}, cfg)


def test_english_encoder_from_a_snapshot_matches_jax(bert_snapshot):
    """The whole call: snapshot config, native WordPiece, chunks of 32, buckets, module."""
    snap, _ = bert_snapshot
    texts = [TEXTS[i % len(TEXTS)] + f" fox {i}" for i in range(40)]
    enc = build_text_encoder("english", str(snap), embedding_dim=16, device="cpu")
    assert enc.is_pretrained and enc.tokenizer_name == "WordPieceTokenizer (native)"
    ref = JEnglish(snap, embedding_dim=16)(texts)
    out = enc(texts)
    assert out.dtype == np.float32 and out.shape == (40, 16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ENC_ATOL)
    np.testing.assert_allclose(enc(texts[3]), ref[3], rtol=0, atol=ENC_ATOL)
    with pytest.raises(ValueError, match="Embedding dimension mismatch"):
        build_text_encoder("english", str(snap), embedding_dim=384, device="cpu")


def test_encoder_without_a_snapshot_draws_seeded_weights(monkeypatch):
    """Weights from a torch.Generator seeded 0 (two builds agree), the hash tokenizer,
    is_pretrained False; CUDA unless told otherwise."""
    a = build_text_encoder("english", device="cpu")
    b = build_text_encoder("english", device="cpu")
    assert not a.is_pretrained and a.tokenizer_name == "HashTokenizer"
    assert a.model.embeddings.word.shape == (30522, 384) and len(a.model.layers) == 6
    emb = a(["energy prices rose", ""])
    np.testing.assert_array_equal(emb, b(["energy prices rose", ""]))
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("english", "japanese"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_text_encoder(kind)
    with pytest.raises(ValueError, match="Unknown text encoder type"):
        build_text_encoder("klingon", device="cpu")


def test_fp32_matmuls_turns_tf32_off_and_restores_the_setting():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with fp32_matmuls():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


HF_CONFIGS = {
    "bert": ({"hidden_size": 32, "num_hidden_layers": 3, "layer_norm_eps": 1e-7, "unknown": 1},
             "bert_config_from_hf"),
    "modernbert": ({"hidden_size": 64, "num_hidden_layers": 4, "local_attention": 32, "norm_eps": 1e-6,
                    "global_rope_theta": 5e4}, "modernbert_config_from_hf"),
    "timesfm": ({"patch_len": 16, "hidden_size": 64, "quantiles": [0.25, 0.5, 0.75]},
                "timesfm_config_from_hf"),
    "chronos": ({"d_model": 64, "num_heads": 4, "chronos_config": {"input_patch_size": 8,
                 "output_patch_size": 8, "quantiles": [0.5]}}, "chronos2_config_from_hf"),
}


@pytest.mark.parametrize("kind", sorted(HF_CONFIGS))
def test_config_from_hf_matches_jax(kind):
    hf, fn = HF_CONFIGS[kind]
    """Every field the port's config shares with JAX's (the port has no ``remat`` or
    ``scan_unroll`` on TimesFM, JAX no ``compute_dtype`` of torch's)."""
    ours = dataclasses.asdict(getattr(tsnap, fn)(hf))
    ref = dataclasses.asdict(getattr(jsnap, fn)(hf))
    ours.pop("compute_dtype", None), ref.pop("compute_dtype", None)
    assert set(ours) <= set(ref)
    assert ours == {key: ref[key] for key in ours}


def test_resolve_snapshot_dir_matches_jax(tmp_path, monkeypatch):
    """A path, the $MULTIMODAL_TIMESFM_SNAPSHOTS layout and the hub cache layout."""
    root = tmp_path / "snaps"
    (root / "org" / "name").mkdir(parents=True)
    (root / "org" / "name" / "config.json").write_text("{}")
    hub = tmp_path / "hub" / "models--org--other" / "snapshots" / "rev1"
    hub.mkdir(parents=True)
    (hub / "model.safetensors").write_bytes(b"")
    monkeypatch.setenv(tsnap.SNAPSHOT_ROOT_ENV, str(root))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    for query in ("org/name", "org/other", str(root / "org" / "name")):
        assert tsnap.resolve_snapshot_dir(query) == jsnap.resolve_snapshot_dir(query)
    with pytest.raises(FileNotFoundError, match="No local snapshot"):
        tsnap.resolve_snapshot_dir("org/missing")
