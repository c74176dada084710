"""PyTorch port vs the JAX package: the Time-MMD loader, the embedding cache, the fold
loader, the cache CLI, and the whole data slice down to two training steps.

Trees of a few dozen rows are written with the ``csv`` module from numpy draws; each
holds one of the pandas behaviours the port's loader reproduces without pandas (NA
strings, integer years, unsorted dates, interior NaN and inf, the search table, dates
with a time, numeric text columns). Windows: bit-equal where the CSV's decimals have up
to 10 significant digits (pandas' float parser and Python's ``float`` then agree);
with 17-digit decimals pandas' parser is off by up to 1e-12 relative, and the windows
are held to ``LONG_DECIMAL_ATOL``. Embeddings: ``ENC_ATOL`` (as in
``test_torch_port_text.py``). Losses: rtol 2e-3, as ``test_trainer_matches_jax``.
"""

import csv
import datetime as dt
import json
import logging
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from examples.time_mmd.cross_validation import DomainSpec as JDomainSpec
from examples.time_mmd.cross_validation import load_fold_datasets as j_load_fold_datasets
from examples.time_mmd.data.time_mmd_dataset import TimeMmdDataset as JTimeMmdDataset
from multimodal_timesfm_tpu.data.preprocess import PreprocessPipeline as JPipeline
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoder as JDecoder
from multimodal_timesfm_tpu.models.decoder import MultimodalDecoderConfig as JDecoderConfig
from multimodal_timesfm_tpu.models.timesfm import TimesFM2p5Adapter as JAdapter
from multimodal_timesfm_tpu.models.timesfm import TimesFMConfig as JConfig
from multimodal_timesfm_tpu.training.evaluator import MultimodalEvaluator as JEvaluator
from multimodal_timesfm_tpu.training.trainer import MultimodalTrainer as JTrainer
from multimodal_timesfm_tpu.training_args import TrainingArguments as JArgs
from multimodal_timesfm_torch.data.dataset import ConcatDataset, PreprocessedDataset
from multimodal_timesfm_torch.data.preprocess import PreprocessPipeline
from multimodal_timesfm_torch.models.bridge import export_jax_params, load_jax_params, random_jax_params
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
from multimodal_timesfm_torch.text import bert as tbert
from multimodal_timesfm_torch.text.convert import hf_bert_state
from multimodal_timesfm_torch.time_mmd import cache as tcache
from multimodal_timesfm_torch.time_mmd.cross_validation import DomainSpec, load_fold_datasets
from multimodal_timesfm_torch.time_mmd.dataset import TimeMmdDataset
from multimodal_timesfm_torch.time_mmd.table import NA_VALUES, CsvTable
from multimodal_timesfm_torch.training.evaluator import MultimodalEvaluator
from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
from multimodal_timesfm_torch.training_args import TrainingArguments

REPO = Path(__file__).resolve().parent.parent
ENC_ATOL = 1e-5
LONG_DECIMAL_ATOL = 1e-6
PATCH, CONTEXT, HORIZON = 4, 16, 8
WORDS = "the energy price report rose fell sharply market demand supply weather rain".split()
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *WORDS, "##s", "##ed", ":", ",", "."]


def _write(path: Path, header: list[str], rows: list[list[str]]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)


def _sentence(rng, lo=1, hi=12) -> str:
    return " ".join(rng.choice(WORDS + ["unseen", "rainfall"], size=int(rng.integers(lo, hi))))


def _write_domain(root, domain, rng, n=48, case="plain", date_col="start_date"):
    """One domain's numerical CSV and report (and, for some cases, search) CSV."""
    days = [dt.date(2020, 1, 1) + dt.timedelta(days=i) for i in range(n)]
    starts = ends = [d.isoformat() for d in days]
    text_dates = list(starts)
    values = [f"{v:.6f}" for v in np.cumsum(rng.normal(size=n)) + 10]
    order = list(range(n))
    facts = [_sentence(rng) for _ in range(0, n, 5)]
    preds = [_sentence(rng) for _ in range(0, n, 5)]
    search = case == "search_table"
    if case == "na_strings":
        na = sorted(NA_VALUES) + ["NA at the start", "  padded text  ", " null", "Nothing new"]
        facts = [na[i % len(na)] for i in range(len(facts))]
        preds = [na[(i + 7) % len(na)] for i in range(len(preds))]
        for i, cell in zip((5, 9, 13, 30), ("NA", "null", "", "N/A")):
            values[i] = cell
    elif case == "integer_years":
        starts = ends = [str(1950 + i) for i in range(n)]
        text_dates = [f"{1950 + i}-01-01" for i in range(n)]
        order = list(np.random.default_rng(1).permutation(n))
    elif case == "unsorted_dates":
        starts = ends = [f"{2000 + i // 12}-{i % 12 + 1:02d}" for i in range(n)]
        text_dates = [f"{2000 + i // 12}-{i % 12 + 1:02d}-01" for i in range(n)]
        order = list(np.random.default_rng(2).permutation(n))
    elif case == "interior_nan_inf":
        cells = ("nan", "inf", "-inf", "NaN", "inf", "NA", "inf", "")
        for i, cell in zip((0, 1, 10, 11, 12, 20, n - 2, n - 1), cells):
            values[i] = cell
    elif case == "datetime":
        starts = [f"{d} 06:00:00" for d in days]
        ends = [f"{d} 18:30:00" for d in days]
    elif case == "numeric_texts":
        preds = [f"{i:03d}" for i in range(len(preds))]  # pandas reads 007 as the integer 7
        facts = [f"{i}e2" if i % 3 else "" for i in range(len(facts))]  # floats: "100.0"
    elif case == "long_decimals":
        values = [repr(float(v)) for v in np.cumsum(rng.normal(size=n)) * 1e3 + 1e5]
    _write(root / "numerical" / domain / f"{domain}.csv", [date_col, "end_date", "OT", "other"],
           [[starts[i], ends[i], values[i], "x"] for i in order])
    rows = [[text_dates[i], text_dates[min(i + 6, n - 1)], f, p]
            for i, f, p in zip(range(0, n, 5), facts, preds)]
    _write(root / "textual" / domain / f"{domain}_report.csv",
           ["start_date", "end_date", "fact", "preds"], rows)
    if search:
        _write(root / "textual" / domain / f"{domain}_search.csv", ["start_date", "end_date", "fact"],
               [[text_dates[i], text_dates[min(i + 3, n - 1)], _sentence(rng)] for i in range(0, n - 2, 3)])


def _assert_same_samples(ours, ref, exact=True):
    assert len(ours) == len(ref) > 0
    for o, r in zip(ours, ref):
        assert o["patched_texts"] == r["patched_texts"]
        om, rm = o["metadata"], r["metadata"]
        assert [type(om[k]) for k in rm] == [type(rm[k]) for k in rm]
        for key in ("context", "horizon"):
            assert o[key].dtype == np.float32
            if exact:
                np.testing.assert_array_equal(o[key], r[key])
            else:
                np.testing.assert_allclose(o[key], r[key], rtol=0, atol=LONG_DECIMAL_ATOL)
        if exact:
            assert om == rm
        else:
            assert {k: om[k] for k in om if k not in ("mean", "std")} == {
                k: rm[k] for k in rm if k not in ("mean", "std")}
            np.testing.assert_allclose([om["mean"], om["std"]], [rm["mean"], rm["std"]], rtol=1e-11)


CASES = ["plain", "na_strings", "integer_years", "unsorted_dates", "interior_nan_inf", "search_table",
         "datetime", "health_afr", "numeric_texts", "long_decimals"]


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_time_mmd_dataset_matches_jax(tmp_path, case, augment):
    """The same count and order of samples, the same patched texts and metadata, and the
    same float32 windows (bit-equal but for the 17-digit case)."""
    rng = np.random.default_rng(CASES.index(case))
    domain = "Health_AFR" if case == "health_afr" else "Env"
    _write_domain(tmp_path, domain, rng, case=case, date_col="date" if case == "health_afr" else "start_date")
    ours = TimeMmdDataset(tmp_path, domain, PATCH, CONTEXT, HORIZON, augment=augment)
    ref = JTimeMmdDataset(tmp_path, domain, PATCH, CONTEXT, HORIZON, augment=augment)
    _assert_same_samples(list(ours), list(ref), exact=case != "long_decimals")
    assert any(any(patch) for s in ours for patch in s["patched_texts"]) or case == "na_strings"
    if case == "numeric_texts":
        assert any("Report Prediction: 7" in t for s in ours for p in s["patched_texts"] for t in p)


def test_interpolation_over_gaps_is_pandas_bit_for_bit():
    """np.interp over the finite points = pandas' linear interpolate + ffill/bfill."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        values = rng.normal(size=50) * 100
        values[rng.random(50) < 0.3] = rng.choice([np.nan, np.inf, -np.inf])
        dates = np.arange(50)
        ref = JTimeMmdDataset._sanitize_series(values, dates, dates)
        ours = TimeMmdDataset._sanitize_series(values)
        if ref is None:
            assert ours is None
            continue
        np.testing.assert_array_equal(ours[0], ref[0])
        np.testing.assert_array_equal(dates[ours[1]:ours[2]], ref[1])


def test_patch_boundaries_truncate_as_pandas_divides_a_timedelta():
    rng = np.random.default_rng(4)
    for _ in range(200):
        start = int(rng.integers(0, 2**50))
        span = int(rng.integers(0, 2**45))
        n = int(rng.integers(1, 64))
        ref = (pd.Timedelta(span, "us") / n).value // 1000
        assert int(span / n) == ref
        assert int(-span / n) == (pd.Timedelta(-span, "us") / n).value // 1000
        assert start + int(span / n) * n <= start + span


def test_csv_cells_read_as_pandas_reads_them(tmp_path):
    """Column kinds (int, float, str), missing cells and printed values, cell by cell."""
    columns = {
        "ints": [" 7", "+2", "-0", "007"],
        "ints_na": ["1", "NA", "3", "4"],
        "floats": ["1.5", ".5", "1e3", "-inf"],
        "strs": ["x", "1", " y ", "null"],
        "empty": ["", "NA", "null", "NaN"],
        "dates": ["2001", "2001-05", "2001-05-03", "2001-05-03 12:34:56"],
    }
    path = tmp_path / "t.csv"
    _write(path, list(columns), [list(row) for row in zip(*columns.values())])
    table = CsvTable.read(path)
    frame = pd.read_csv(path)
    kinds = {"i": "int", "f": "float", "O": "str", "U": "str"}
    for name in columns:
        assert table.kind(name) == kinds.get(frame[name].dtype.kind, "str"), name
        expected = [None if pd.isna(v) else str(v) for v in frame[name]]
        assert table.values(name) == expected, name
    bom = tmp_path / "bom.csv"
    bom.write_text(path.read_text(), encoding="utf-8-sig")
    assert CsvTable.read(bom).columns == list(pd.read_csv(bom).columns) == list(columns)
    ours = table.take(table.order("strs")).values("strs")
    assert ours == [None if pd.isna(v) else v for v in frame.sort_values("strs")["strs"]]
    from multimodal_timesfm_torch.time_mmd.table import parse_date

    for value in columns["dates"] + ["2001/5/3", " 2020-01-01 ", "2001-05-03T12:00:00.5"]:
        ref = (pd.to_datetime(value) - pd.Timestamp("1970-01-01")) // pd.Timedelta(1, "us")
        assert parse_date(path, value) == ref, value


@pytest.mark.parametrize(
    "where,cell,message",
    [("numerical", "12abc", "cannot parse '12abc' in column 'OT' as a number"),
     ("numerical_date", "yesterday", "cannot parse 'yesterday' as a date"),
     ("report_date", "1999", "holds numbers, not dates"),
     ("ragged", "extra", "has 5 fields, the header 4")],
)
def test_unparseable_cells_raise_naming_file_and_value(tmp_path, where, cell, message):
    _write_domain(tmp_path, "Env", np.random.default_rng(5))
    num = tmp_path / "numerical" / "Env" / "Env.csv"
    rep = tmp_path / "textual" / "Env" / "Env_report.csv"
    if where in ("numerical", "ragged"):
        lines = num.read_text().splitlines()
        lines[10] = lines[10].replace(",x", f",{cell},x") if where == "ragged" else ",".join(
            lines[10].split(",")[:2] + [cell, "x"])
        num.write_text("\n".join(lines) + "\n")
    elif where == "numerical_date":
        lines = num.read_text().splitlines()
        lines[3] = cell + lines[3][10:]
        num.write_text("\n".join(lines) + "\n")
    else:
        rows = list(csv.reader(rep.open()))
        _write(rep, rows[0], [[cell, cell, *r[2:]] for r in rows[1:]])
    with pytest.raises(ValueError, match=message) as info:
        TimeMmdDataset(tmp_path, "Env", PATCH, CONTEXT, HORIZON)
    assert "Env" in str(info.value)


# ---------------------------------------------------------------------------
# caches, the fold loader, the CLI and the whole slice
# ---------------------------------------------------------------------------

DOMAINS = ["Agriculture", "Economy", "Environment"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("time_mmd")
    rng = np.random.default_rng(7)
    for i, domain in enumerate(DOMAINS):
        _write_domain(root, domain, rng, n=40 + 16 * i, case="search_table" if i == 1 else "plain")
    return root


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A 384-wide, one-layer BERT snapshot (``pytorch_model.bin``, so no safetensors is
    needed to read it), drawn with numpy, with a vocab of the trees' words."""
    cfg = tbert.BertConfig(vocab_size=len(VOCAB), num_layers=1, intermediate_size=64)
    snap = tmp_path_factory.mktemp("minilm")
    rng = np.random.default_rng(8)
    sd = {name: torch.from_numpy(rng.normal(0.0, 0.3, leaf.shape).astype(np.float32))
          for name, leaf in hf_bert_state(export_jax_params(tbert.BertEncoder(cfg))).items()}
    torch.save(sd, snap / "pytorch_model.bin")
    (snap / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    (snap / "config.json").write_text(json.dumps({
        "hidden_size": 384, "num_hidden_layers": 1, "num_attention_heads": 12,
        "intermediate_size": 64, "vocab_size": len(VOCAB),
    }))
    return snap


@pytest.fixture(scope="module")
def run_configs(tmp_path_factory):
    cfg_dir = tmp_path_factory.mktemp("configs")
    (cfg_dir / "model.yml").write_text(yaml.safe_dump({
        "adapter": {"type": "timesfm", "patch_len": PATCH},
        "fusion": {"text_encoder_type": "english", "text_embedding_dims": 384},
    }))
    (cfg_dir / "forecast.yml").write_text(yaml.safe_dump({"context_len": CONTEXT, "horizon_len": HORIZON}))
    return cfg_dir


def _cli_args(tree, snapshot, run_configs, cache_dir, augment):
    return ["--data-path", str(tree), "--model-config", str(run_configs / "model.yml"),
            "--forecast-config", str(run_configs / "forecast.yml"), "--text-encoder-type", "english",
            "--text-model-dir", str(snapshot), "--cache-dir", str(cache_dir), "--seed", "0",
            *(["--augment"] if augment else [])]


@pytest.fixture(scope="module")
def caches(tree, snapshot, run_configs, tmp_path_factory):
    """Plain and augmented caches of every domain, built by each package's CLI."""
    import scripts.cache_time_mmd_datasets as jcache

    port_dir, jax_dir = tmp_path_factory.mktemp("port_cache"), tmp_path_factory.mktemp("jax_cache")
    argv = sys.argv
    try:
        for augment in (False, True):
            argv = _cli_args(tree, snapshot, run_configs, port_dir, augment)
            assert tcache.main(argv + ["--device", "cpu"]) == 0
            sys.argv = ["cache", *_cli_args(tree, snapshot, run_configs, jax_dir, augment)]
            assert jcache.main() == 0
    finally:
        sys.argv = argv
    return port_dir, jax_dir


def _walk_types(node, seen):
    seen.add(type(node))
    if isinstance(node, dict):
        for key, value in node.items():
            seen.add(type(key))
            _walk_types(value, seen)
    elif isinstance(node, list):
        for value in node:
            _walk_types(value, seen)
    return seen


def test_cache_cli_matches_jax(caches):
    """The same files; the same samples and metadata (provenance stamp included);
    embeddings within ENC_ATOL; the pickles hold only dicts, lists, Python scalars and
    float32 numpy arrays."""
    port_dir, jax_dir = caches
    names = sorted(p.name for p in port_dir.glob("*.pkl"))
    assert names == sorted(p.name for p in jax_dir.glob("*.pkl")) and len(names) == 2 * len(DOMAINS)
    for name in names:
        ours = pickle.loads((port_dir / name).read_bytes())
        ref = pickle.loads((jax_dir / name).read_bytes())
        assert len(ours) == len(ref) > 0
        for o, r in zip(ours, ref):
            assert o["metadata"] == r["metadata"]
            assert o["metadata"]["text_encoder"] == {"encoder": "EnglishTextEncoder", "is_pretrained": True}
            np.testing.assert_array_equal(o["context"], r["context"])
            assert o["text_embeddings"].shape == (CONTEXT // PATCH, 384)
            np.testing.assert_allclose(o["text_embeddings"], r["text_embeddings"], rtol=0, atol=ENC_ATOL)
        assert _walk_types(ours, set()) <= {list, dict, str, int, float, bool, np.ndarray}
        dtypes = {a.dtype for s in ours for a in s.values() if isinstance(a, np.ndarray)}
        assert dtypes == {np.dtype(np.float32)}


def test_caches_cross_between_packages(caches, tree, tmp_path, caplog):
    """A cache written by either package loads in the other with equal contents; an
    unstamped-pretrained cache warns, and is refused when pretrained embeddings are required."""
    port_dir, jax_dir = caches
    name = "time_mmd_Agriculture_english_p4_c16_h8.pkl"
    for writer, reader in ((port_dir, JPipeline), (jax_dir, PreprocessPipeline)):
        loaded = reader(writer).load(writer / name, require_pretrained_embeddings=True)
        direct = pickle.loads((writer / name).read_bytes())
        for a, b in zip(loaded, direct):
            assert a["metadata"] == b["metadata"]
            for key in ("context", "horizon", "text_embeddings"):
                np.testing.assert_array_equal(a[key], b[key])

    samples = pickle.loads((jax_dir / name).read_bytes())
    for s in samples:
        s["metadata"]["text_encoder"]["is_pretrained"] = False
    (tmp_path / name).write_bytes(pickle.dumps(samples))
    with caplog.at_level(logging.WARNING, logger="multimodal_timesfm_torch"):
        PreprocessPipeline(tmp_path).load(tmp_path / name)
    assert "WITHOUT pretrained" in caplog.text
    with pytest.raises(ValueError, match="WITHOUT pretrained"):
        PreprocessPipeline(tmp_path).load(tmp_path / name, require_pretrained_embeddings=True)
    with pytest.raises(FileNotFoundError, match="multimodal_timesfm_torch.time_mmd.cache"):
        PreprocessPipeline(tmp_path).load(tmp_path / "missing.pkl")

    # The port's stamp of an encoder without pretrained weights: JAX warns and refuses too.
    class HashEncoder:
        is_pretrained = False

        def __call__(self, texts):
            return np.ones((len(texts), 3), np.float32)

    pipeline = PreprocessPipeline(tmp_path / "port")
    path = pipeline.get_path("time_mmd", "Economy", "english", PATCH, CONTEXT, HORIZON)
    factory = lambda: TimeMmdDataset(tree, "Economy", PATCH, CONTEXT, HORIZON)  # noqa: E731
    built = pipeline.prepare(path, factory, HashEncoder())
    assert built[0]["metadata"]["text_encoder"] == {"encoder": "HashEncoder", "is_pretrained": False}
    assert len(JPipeline(tmp_path / "port").load(path)) == len(built)
    with pytest.raises(ValueError, match="WITHOUT pretrained"):
        JPipeline(tmp_path / "port").load(path, require_pretrained_embeddings=True)


def _fold(spec_cls, loader, cache_dir):
    train = [spec_cls(d, augment=True) for d in DOMAINS[:2]]
    return loader(train, [spec_cls("Environment")], [spec_cls("Environment", augment=True)],
                  "english", PATCH, CONTEXT, HORIZON, cache_dir)


def test_load_fold_datasets_matches_jax(caches):
    port_dir, jax_dir = caches
    ours = _fold(DomainSpec, load_fold_datasets, port_dir)
    ref = _fold(JDomainSpec, j_load_fold_datasets, jax_dir)
    for o, r in zip(ours, ref):
        assert isinstance(o, ConcatDataset) and all(isinstance(d, PreprocessedDataset) for d in o.datasets)
        assert len(o) == len(r) > 0
        assert [s["metadata"] for s in o] == [s["metadata"] for s in r]
        assert o[-1]["metadata"] == r[len(r) - 1]["metadata"]
    with pytest.raises(IndexError):
        ours[0][-len(ours[0]) - 1]
    with pytest.raises(ValueError, match="text_embeddings"):
        PreprocessedDataset([{"context": np.zeros(4), "horizon": np.zeros(2), "metadata": {}}], "multimodal")


def test_whole_slice_two_training_steps_match_jax(caches, tmp_path):
    """Caches -> fold -> two multimodal training steps of a tiny TimesFM in each package (each
    on its own caches, the same weights and seed), then the evaluator on the test fold."""
    port_dir, jax_dir = caches
    train, val, test = _fold(DomainSpec, load_fold_datasets, port_dir)
    jtrain, jval, jtest = _fold(JDomainSpec, j_load_fold_datasets, jax_dir)
    port = MultimodalDecoder(TimesFM2p5Adapter(TimesFMConfig.tiny()),
                             MultimodalDecoderConfig(text_embedding_dims=384), device="cpu")
    tree = random_jax_params(port, 9)
    load_jax_params(port, tree)
    jdec = JDecoder(JAdapter(JConfig.tiny()), JDecoderConfig(text_embedding_dims=384))
    batch = (len(train) + 1) // 2
    kw = dict(per_device_train_batch_size=batch, per_device_eval_batch_size=8, num_train_epochs=1,
              learning_rate=1e-3, eval_strategy="epoch", save_strategy="no", logging_strategy="no", seed=3)
    pt = MultimodalTrainer(port, TrainingArguments(output_dir=str(tmp_path / "p"), **kw), train, val,
                           "multimodal", device="cpu")
    jt = JTrainer(jdec, jax.tree.map(jnp.asarray, tree), JArgs(output_dir=str(tmp_path / "j"), **kw),
                  jtrain, jval, "multimodal", fuse_epochs=False)
    ours = (pt.train_epoch(), pt.validate_epoch())
    ref = (jt.train_epoch(), jt.validate_epoch())
    assert pt.global_step == jt.global_step == 2
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    params = {"adapter": jax.tree.map(jnp.asarray, tree["adapter"]), "fusion": jt.state.trainable}
    ours_m = MultimodalEvaluator(pt.eval_model, device="cpu").evaluate(list(test), batch_size=8)
    ref_m = JEvaluator(jdec).evaluate(params, list(jtest), batch_size=8)
    for name in ref_m:
        np.testing.assert_allclose(ours_m[name], ref_m[name], rtol=2e-3, err_msg=name)


_NO_OPTIONAL_PACKAGES = """
import json, sys
from pathlib import Path
for name in ("pandas", "yaml", "safetensors", "transformers", "jax", "jaxlib",
             "multimodal_timesfm_tpu", "examples"):
    sys.modules[name] = None
tree, snapshot, cache_dir = sys.argv[1:4]
configs = Path(cache_dir)
model = {"adapter": {"patch_len": 32}, "fusion": {"text_embedding_dims": 384}}
(configs / "model.json").write_text(json.dumps(model))
(configs / "forecast.json").write_text(json.dumps({"context_len": 32, "horizon_len": 32}))
(configs / "forecast.yml").write_text("context_len: 32\\n")
from multimodal_timesfm_torch.time_mmd import cache
from multimodal_timesfm_torch.time_mmd.cross_validation import DomainSpec, load_fold_datasets
from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
from multimodal_timesfm_torch.utils.yaml import load_yaml
assert cache.main(["--data-path", tree, "--text-encoder-type", "english", "--text-model-dir", snapshot,
                   "--model-config", str(configs / "model.json"),
                   "--forecast-config", str(configs / "forecast.json"),
                   "--cache-dir", cache_dir, "--domains", "Environment", "--device", "cpu"]) == 0
spec = [DomainSpec("Environment")]
train, val, test = load_fold_datasets(spec, spec, spec, "english", 32, 32, 32, cache_dir)
assert len(train) > 0 and train[0]["text_embeddings"].shape == (1, 384)
try:
    load_yaml(configs / "forecast.yml")
except ImportError as exc:
    assert "PyYAML" in str(exc)
else:
    raise AssertionError("a YAML file read without PyYAML")
print("ok", len(train))
"""


def test_the_card_path_needs_no_pandas_yaml_safetensors_or_transformers(tree, snapshot, tmp_path):
    """The loader, the encoder from a ``pytorch_model.bin`` snapshot, the cache CLI with JSON
    configs, the fold loader and the trainer's imports, in a process where those imports
    fail; a YAML-only file then names PyYAML."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_OPTIONAL_PACKAGES, str(tree), str(snapshot), str(tmp_path)],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")
