"""PyTorch port vs the JAX package: patching, RevIN, dense and the norms.

Inputs are drawn with numpy from a seed and fed to both packages; the port
runs on the CPU. Tolerances are stated per test. Also checks that the port
and ``chip_smoke.py`` import nothing of JAX, and that a kernel build that
fails raises instead of falling back.
"""

import ast
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_timesfm_tpu.models import layers as jl
from multimodal_timesfm_tpu.ops import patching as jp
from multimodal_timesfm_tpu.ops.revin import masked_running_stats as j_running_stats
from multimodal_timesfm_tpu.ops.revin import revin as j_revin
from multimodal_timesfm_torch.models import layers as tl
from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops import patching as tp
from multimodal_timesfm_torch.ops import revin as tr
from multimodal_timesfm_torch.ops.qkv_attention import fused_qkv_causal_attention

REPO = Path(__file__).resolve().parent.parent

# fp32: identical formulas, only summation order differs. bf16: both round the
# same intermediates to bf16; one bf16 ulp is 2^-8 relative.
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_patchify_unpatchify_and_pad():
    x = np.random.default_rng(0).normal(size=(3, 22)).astype(np.float32)
    jp_patches, jp_mask = jp.pad_and_patchify(jnp.asarray(x), 8)
    tp_patches, tp_mask = tp.pad_and_patchify(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(_np(tp_patches), _np(jp_patches))
    np.testing.assert_array_equal(tp_mask.numpy(), np.asarray(jp_mask))
    np.testing.assert_array_equal(_np(tp.unpatchify(tp_patches)), _np(jp.unpatchify(jp_patches)))
    with pytest.raises(ValueError, match="divisible"):
        tp.patchify(torch.from_numpy(x), 8)


@pytest.mark.parametrize("offset", [0.0, 1e4])
def test_masked_running_stats(offset):
    """The closed form with its first-valid-value shift, incl. a 1e4 offset and an
    all-padded prefix (rows 1 and 2). Tolerance: 1e-4 absolute on O(1) stats."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 6, 4)) + offset).astype(np.float32)
    m = rng.random((4, 6, 4)) < 0.3
    m[1, :2] = True  # two all-padded patches first
    m[2] = True  # no valid point at all
    jmu, jsig = j_running_stats(jnp.asarray(x), jnp.asarray(m))
    tmu, tsig = tr.masked_running_stats(torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_allclose(_np(tmu), _np(jmu), atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(_np(tsig), _np(jsig), atol=1e-4)
    assert _np(tsig)[0, -1] > 0.5  # no fp32 cancellation at the offset


@pytest.mark.parametrize("reverse", [False, True])
def test_revin(reverse):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 7)).astype(np.float32)
    mu = rng.normal(size=(3, 5)).astype(np.float32)
    sigma = np.abs(rng.normal(size=(3, 5))).astype(np.float32)
    sigma[0, 0] = 1e-8  # below 1e-6: treated as 1
    ref = j_revin(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(sigma), reverse=reverse)
    out = tr.revin(torch.from_numpy(x), torch.from_numpy(mu), torch.from_numpy(sigma), reverse=reverse)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    w = rng.normal(size=(24, 16)).astype(np.float32) / 5  # JAX (in, out)
    b = rng.normal(size=(16,)).astype(np.float32)
    ref = jl.dense({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x, JDT[dtype]))
    out = tl.dense(torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    assert out.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 4, 32)) * 3).astype(np.float32)
    scale = (rng.normal(size=(32,)) * 0.1).astype(np.float32)
    ref = jl.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x, JDT[dtype]))
    out = tl.rms_norm(torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(scale))
    assert out.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 4, 32)) * 3 + 1).astype(np.float32)
    scale = (1 + rng.normal(size=(32,)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(32,)) * 0.1).astype(np.float32)
    ref = jl.layer_norm(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x, JDT[dtype])
    )
    out = tl.layer_norm(
        torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(scale), torch.from_numpy(bias)
    )
    assert out.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_port_imports_no_jax():
    files = sorted((REPO / "multimodal_timesfm_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    # The parallel layer is walked too, and imports as a package.
    import multimodal_timesfm_torch.parallel  # noqa: F401

    parallel_files = set((REPO / "multimodal_timesfm_torch" / "parallel").glob("*.py"))
    assert {f.name for f in parallel_files} >= {"__init__.py", "mesh.py", "sharding.py", "distributed.py"}
    assert parallel_files <= set(files)
    bad = [
        f"{f.relative_to(REPO)}: {name}"
        for f in files
        for name in _imported_modules(f)
        if name.split(".")[0] in ("jax", "jaxlib", "multimodal_timesfm_tpu", "examples", "bench", "orbax")
    ]
    assert not bad, bad


def test_the_completion_modules_import_no_bench_or_orbax():
    """The profiling module, the roofline, the checkpoints (orbax directories are read with
    tensorstore) and serving import neither the root ``bench`` nor ``orbax``, nor JAX, at
    any level; they are walked by the guard above too."""
    port = REPO / "multimodal_timesfm_torch"
    files = [port / name for name in ("utils/profiling.py", "roofline.py", "training/checkpoint.py", "serving.py")]
    bad = [
        f"{f.relative_to(REPO)}: {name}"
        for f in files
        for name in _imported_modules(f)
        if name.split(".")[0] in ("bench", "orbax", "jax", "jaxlib", "multimodal_timesfm_tpu")
    ]
    assert not bad, bad


_TOP_LEVEL = """
import sys
import typing
import torch
import multimodal_timesfm_torch as port
from multimodal_timesfm_torch import Batch, EvaluationMetrics, PreprocessedSample, RawSample, TrainingMode
hints = typing.get_type_hints(Batch)
assert hints["context"] is hints["horizon"] is torch.Tensor
assert set(hints) == {"context", "horizon", "text_embeddings", "metadata"}
assert not torch.cuda.is_initialized()
assert "multimodal_timesfm_torch.ops._kernels" not in sys.modules
assert not [m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in ("jax", "multimodal_timesfm_tpu")]
print(port.__version__)
"""


def test_the_top_level_exports_the_jax_packages_names():
    """``__version__`` equals the JAX package's and the five names of its ``__init__`` are
    re-exported; importing the top level builds no kernel and does not touch CUDA (a fresh
    interpreter, JAX blocked)."""
    import subprocess
    import sys

    import multimodal_timesfm_tpu

    code = "import sys\nfor m in ('jax', 'jaxlib', 'multimodal_timesfm_tpu'):\n    sys.modules[m] = None\n" + _TOP_LEVEL
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == multimodal_timesfm_tpu.__version__


def test_the_pretrained_to_served_path_imports_no_optional_package():
    """The snapshot readers, checkpoints, serving and the CLIs import neither
    ``safetensors`` nor ``transformers`` (the card's installation has no such
    package; the port reads safetensors itself), at any level of the module."""
    port = REPO / "multimodal_timesfm_torch"
    files = [port / name for name in (
        "utils/safetensors.py", "utils/cache.py", "models/convert.py", "models/base.py",
        "training/checkpoint.py", "training/trainer.py", "inference.py", "serving.py",
        "forecast.py", "export.py", "time_mmd/models.py", "text/convert.py",
    )]
    bad = [
        f"{f.relative_to(REPO)}: {name}"
        for f in files
        for name in _imported_modules(f)
        if name.split(".")[0] in ("safetensors", "transformers", "jax", "multimodal_timesfm_tpu", "examples")
    ]
    assert not bad, bad


def test_the_sweep_path_imports_no_jax_or_pandas():
    """The split CLI, the vectorized trials, the sweep library, the tracking copy, the tune
    CLIs and the parallel layer under them are walked by the guard above, and import
    neither the JAX package, ``examples`` nor pandas (the split CLI writes with the ``csv``
    module), at any level."""
    port = REPO / "multimodal_timesfm_torch"
    files = [port / name for name in (
        "time_mmd/split.py", "time_mmd/sweep_lib.py", "training/vectorized.py", "utils/tracking.py",
        "tune.py", "tune_baseline.py", "parallel/__init__.py", "parallel/mesh.py", "parallel/sharding.py",
        "parallel/distributed.py", "parallel/collectives.py",
    )]
    walked = set(sorted((REPO / "multimodal_timesfm_torch").rglob("*.py")))
    assert all(f in walked for f in files)
    bad = [
        f"{f.relative_to(REPO)}: {name}"
        for f in files
        for name in _imported_modules(f)
        if name.split(".")[0] in ("jax", "jaxlib", "multimodal_timesfm_tpu", "examples", "pandas")
    ]
    assert not bad, bad


def _meta_qkv():
    qkv = torch.empty(2, 16, 3 * 2 * 8, device="meta")
    return qkv, torch.ones(2, 16, dtype=torch.bool, device="meta")


def test_kernel_wrapper_raises_without_nvcc(monkeypatch, tmp_path):
    """A tensor that is not on the CPU goes to the kernel, whose build fails loudly."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "nvcc_path", no_nvcc)
    _kernels.library.cache_clear()
    before = fused_qkv_causal_attention.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_qkv_causal_attention(*_meta_qkv(), 2, 8)
    assert fused_qkv_causal_attention.launches == before


def test_kernel_build_failure_quotes_nvcc_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'attention_fwd.cu(1): error: simulated' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "nvcc_path", lambda: str(fake))
    _kernels.library.cache_clear()
    with pytest.raises(RuntimeError, match="(?s)exit code 2.*error: simulated"):
        fused_qkv_causal_attention(*_meta_qkv(), 2, 8)
    assert not list((tmp_path / "build").glob("*.so*"))


@pytest.mark.parametrize("edit", ["edit a header", "add a header", "edit a source"])
def test_library_name_hashes_every_file_under_csrc(monkeypatch, tmp_path, edit):
    """An edit to any file under csrc/, a header included by the sources too, names a new
    library, so the card never loads one built from stale sources."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    before = _kernels.library_path()
    assert _kernels.library_path() == before
    if edit == "edit a header":
        header = csrc / "attention_common.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
    elif edit == "add a header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    else:
        source = csrc / "attention_fwd.cu"
        source.write_text(source.read_text() + "\n// edited\n")
    assert _kernels.library_path() != before


def test_every_cuda_source_under_csrc_is_built():
    """The library is linked from every ``.cu`` file under csrc/ (one nvcc each), so a kernel
    source added beside the others cannot be left out of the build."""
    assert sorted(_kernels.SOURCES) == sorted(_kernels.CSRC.glob("*.cu"))


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.normal(size=(2, 8, 3 * 2 * 4)).astype(np.float32))
    before = fused_qkv_causal_attention.launches
    out = fused_qkv_causal_attention(qkv, torch.ones(2, 8, dtype=torch.bool), 2, 4)
    assert out.shape == (2, 8, 8)
    assert fused_qkv_causal_attention.launches == before
