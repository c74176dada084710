"""PyTorch port: the attention ops registered in C++ and ``mtt_serve``, the package's native server.

Built here with the host's C++ compiler against the installed torch, the CPU
half only (no ``nvcc``). The four schemas of ``csrc/mtt_ops.cpp`` are the
Python ops' character for character; its CPU ops, loaded as ``mtt_native``,
are bit-equal to the Python plain versions (the same ATen ops in the same
order) in fp32 and bf16. ``mtt_serve`` serves the AOTInductor package of
``tests/test_torch_port_aoti.py``'s fixture (TimesFM multimodal fp32, 2
layers) within 2e-5 x std of ``serving.load_program`` and of JAX's StableHLO
artifact on the same weights, at batches 1, 3 and 7; refuses what it cannot
serve by name; and links no Python.
"""

import re
import shutil
import struct
import subprocess
import zipfile
import zlib

import numpy as np
import pytest
import torch

from multimodal_timesfm_torch import native, serving
from multimodal_timesfm_torch.ops.attention import plain_causal_attention
from multimodal_timesfm_torch.ops.chronos_attention import plain_chronos_attention
from multimodal_timesfm_torch.ops.qkv_attention import plain_qkv_causal_attention, split_heads
from multimodal_timesfm_tpu.serving import load_stablehlo
from tests.test_torch_port_aoti import package  # noqa: F401  (the module's fixture)
from tests.test_torch_port_serving import TEXT, _close

OPS = native.OPS


@pytest.fixture(scope="module")
def made():
    """The CPU build of the server and both ops libraries."""
    return native.build(cuda=False)


@pytest.fixture(scope="module")
def check_ops(made):
    return native.load_check_ops("cpu")


@pytest.mark.parametrize("op", OPS)
def test_cpp_schemas_equal_the_python_ops(op):
    """A schema that differs only in ``int`` against ``SymInt`` fails inside the package's
    proxy executor at run time; the C++ definitions must be the Python ops' own."""
    defs = re.findall(r'm\.def\("([^"]+)"\)', native.OPS_SOURCE.read_text())
    assert len(defs) == len(OPS)
    want = str(getattr(torch.ops.mtt, op).default._schema).removeprefix("mtt::")
    assert [d for d in defs if d.startswith(op + "(")] == [want]


def _causal_inputs(dtype, seed):
    """A (3, 9, 3*2*8) projection (q pre-scaled) and a key mask with a left-padded row and
    a row with no valid key."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(3, 9, 3 * 2 * 8)).astype(np.float32) / 8 ** 0.25).to(dtype)
    valid = torch.ones(3, 9, dtype=torch.bool)
    valid[1, :4] = False
    valid[2] = False
    return qkv, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("op", OPS)
def test_cpp_cpu_op_matches_the_python_plain_version(check_ops, op, dtype):
    """Bit-equal, not within a tolerance: the C++ CPU ops run the Python plain versions' ATen
    ops in the same order (bf16 rounding where Python rounds). Causal ops take q, k, v as
    strided views of one projection; the Chronos op three segments and padded tokens of ids
    of their own. Each output is contiguous, as a package compiled from the Python ops'
    fake implementations needs."""
    qkv, valid = _causal_inputs(dtype, seed=OPS.index(op))
    heads, dim = 2, 8
    if op == "fused_chronos_attention":
        rng = np.random.default_rng(7)
        seg = torch.from_numpy(np.repeat(np.arange(3, dtype=np.int32), 3)[None].repeat(3, 0))
        seg[1, [2, 5]] = torch.tensor([-1, -2], dtype=torch.int32)
        bias = torch.from_numpy(rng.normal(size=(heads, 9, 9)).astype(np.float32))
        args, want = (qkv, seg, bias), plain_chronos_attention(qkv, seg, bias)
    elif op == "fused_qkv_causal_attention":
        args, want = (qkv, valid, heads, dim), plain_qkv_causal_attention(qkv, valid, heads, dim)
    else:
        q, k, v = split_heads(qkv, heads, dim)
        assert q.stride(1) == 3 * heads * dim
        args, want = (q, k, v, valid), plain_causal_attention(q, k, v, valid)
    out = getattr(check_ops, op)(*args)
    assert out.dtype == dtype and out.is_contiguous()
    assert torch.equal(out, want)
    assert torch.equal(out, getattr(torch.ops.mtt, op)(*args))
    assert native.launch_counts(native.build(cuda=False).check_ops)[op] == 0  # plain versions launch nothing


@pytest.mark.parametrize("batch", [1, 3, 7])
def test_server_matches_load_program_and_jax_stablehlo(package, batch):  # noqa: F811
    """``test_package_matches_jax_stablehlo``'s inputs through the server in a process with
    no Python; 7 rows go in batches of 3, the last padded."""
    art, hlo, _ = package
    rng = np.random.default_rng(2)
    for size in (1, 3, 7):  # the same draws as test_package_matches_jax_stablehlo
        ctx = (rng.normal(size=(size, 16)) * 3 + 10).astype(np.float32)
        txt = rng.normal(size=(size, 4, TEXT)).astype(np.float32)
        if size == batch:
            break
    outs, info = native.serve(art, ctx, txt, device="cpu", batch=min(batch, 3), repeat=1)
    assert set(outs) == {"point_forecast"} and info["device"] == "cpu"
    assert info["batches"] == 2 * -(-batch // 3) and len(info["series_per_s"]) == 1
    assert info["launches"] == dict.fromkeys(OPS, 0)
    assert info["flags"]["allow_tf32_cublas"] is False
    _close(outs["point_forecast"], serving.load_program(art, device="cpu")[0](ctx, txt)["point_forecast"].numpy())
    _close(outs["point_forecast"], load_stablehlo(hlo)[0](ctx, txt)["point_forecast"])


def _zip64_everywhere(src, dst):
    """Rewrite an ``.npz`` so that every size and offset lies in zip64 extra fields, the central
    directory's too, as in an archive past 4 GiB (numpy's own archives put them in the local
    headers only, with placeholders there)."""
    with zipfile.ZipFile(src) as z:
        members = [(info.filename.encode(), z.read(info.filename)) for info in z.infolist()]
    out, central = bytearray(), bytearray()
    for name, data in members:
        crc, offset, size = zlib.crc32(data), len(out), len(data)
        extra = struct.pack("<HHQQ", 1, 16, size, size)
        out += struct.pack("<IHHHHHIIIHH", 0x04034B50, 45, 0, 0, 0, 0, crc, 0xFFFFFFFF, 0xFFFFFFFF, len(name),
                           len(extra)) + name + extra + data
        extra = struct.pack("<HHQQQ", 1, 24, size, size, offset)
        central += struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, 45, 45, 0, 0, 0, 0, crc, 0xFFFFFFFF, 0xFFFFFFFF,
                               len(name), len(extra), 0, 0, 0, 0, 0xFFFFFFFF) + name + extra
    start, record = len(out), len(out) + len(central)
    out += central
    out += struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0, 0, len(members), len(members), len(central), start)
    out += struct.pack("<IIQI", 0x07064B50, 0, record, 1)
    out += struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, 0xFFFF, 0xFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0)
    dst.write_bytes(bytes(out))


def test_server_reads_sizes_and_offsets_from_the_zip64_central_directory(package, tmp_path):  # noqa: F811
    """The same weights in an archive whose central directory holds every size and offset
    in zip64 fields serve bit-equal forecasts."""
    art, _, _ = package
    copy = tmp_path / "copy"
    shutil.copytree(art, copy)
    _zip64_everywhere(art / "params.npz", copy / "params.npz")
    with np.load(art / "params.npz") as want, np.load(copy / "params.npz") as got:
        assert want.files == got.files and all(np.array_equal(want[k], got[k]) for k in want.files)
    rng = np.random.default_rng(5)
    ctx = rng.normal(size=(4, 16)).astype(np.float32)
    txt = rng.normal(size=(4, 4, TEXT)).astype(np.float32)
    first = native.serve(art, ctx, txt, device="cpu", batch=4, repeat=0)[0]["point_forecast"]
    again = native.serve(copy, ctx, txt, device="cpu", batch=4, repeat=0)[0]["point_forecast"]
    assert np.array_equal(first, again)


def _refusal(made, argv):
    done = subprocess.run([str(made.server), *map(str, argv), "--ops-lib", str(made.ops)],
                          capture_output=True, text=True)
    assert done.returncode == native.REFUSED, done.stderr
    assert done.stdout == ""
    return done.stderr


@pytest.mark.parametrize("case", ["program", "device", "text"])
def test_server_refuses_by_name(package, made, tmp_path, case):  # noqa: F811
    """A torch.export program, a device the package was not compiled for (CUDA, the
    server's default) and a multimodal package without --text: exit code 2, named."""
    art, _, port = package
    ctx = np.zeros((2, 16), np.float32)
    np.save(tmp_path / "c.npy", ctx)
    np.save(tmp_path / "t.npy", np.zeros((2, 4, TEXT), np.float32))
    out = tmp_path / "out"
    if case == "program":
        prog = serving.export_program(port, 8, 16, tmp_path / "prog", multimodal=True)
        err = _refusal(made, [prog, "--context", tmp_path / "c.npy", "--text", tmp_path / "t.npy", "--out", out,
                              "--device", "cpu"])
        assert "torch.export program" in err and "AOTInductor" in err
        with pytest.raises(ValueError, match="torch.export program"):
            native.serve(prog, ctx, np.zeros((2, 4, TEXT), np.float32), device="cpu")
    elif case == "device":
        err = _refusal(made, [art, "--context", tmp_path / "c.npy", "--text", tmp_path / "t.npy", "--out", out])
        assert "compiled for ['cpu']" in err and "cannot serve on 'cuda'" in err
    else:
        err = _refusal(made, [art, "--context", tmp_path / "c.npy", "--out", out, "--device", "cpu"])
        assert "exported multimodal: pass --text" in err
    assert not out.exists()


def test_server_links_no_python(made):
    """The server's NEEDED entries name libtorch and no libpython or libtorch_python."""
    for path in (made.server, made.ops):
        done = subprocess.run(["readelf", "-d", str(path)], capture_output=True, text=True, check=True)
        libs = re.findall(r"\(NEEDED\)\s+Shared library: \[([^\]]+)\]", done.stdout)
        assert any(lib.startswith("libtorch") for lib in libs), libs
        assert not [lib for lib in libs if lib.startswith(("libpython", "libtorch_python"))], libs


def test_cuda_is_the_default(package):  # noqa: F811
    """Without a device the server runs on CUDA: on a host without a card that raises, on
    one with a card this CPU package is refused; neither serves on the CPU instead."""
    art, _, _ = package
    error, match = ((ValueError, "cannot serve on 'cuda'") if torch.cuda.is_available()
                    else (RuntimeError, "no CUDA device"))
    with pytest.raises(error, match=match):
        native.serve(art, np.zeros((1, 16), np.float32), np.zeros((1, 4, TEXT), np.float32))


def test_a_cuda_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The CUDA build links the kernel library, which nvcc builds: without nvcc it raises
    and does not fall back to the CPU build."""
    from multimodal_timesfm_torch.ops import _kernels

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kernels")
    _kernels.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            native.build(cuda=True)
    finally:
        _kernels.library.cache_clear()
