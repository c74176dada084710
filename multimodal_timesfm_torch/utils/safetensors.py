"""Read and write the safetensors format without the ``safetensors`` package.

A file is an 8-byte little-endian header length N, a JSON header of N bytes,
then the tensors' raw little-endian bytes. The header maps each name to
``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the byte
buffer after the header) and may hold a ``__metadata__`` dict of strings.

Supported dtypes: F32, F16, BF16, I64 and I32. BF16 is read as 16-bit
integers and viewed as ``torch.bfloat16``, so no numpy bfloat16 type is
needed. A
malformed file (a header length past the end, a bad header, an offset out of
range or a size that does not match the shape, an unknown dtype) raises
``ValueError`` naming the file.
"""

from __future__ import annotations

import json
import math
import os
import struct
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

_NUMPY = {"F32": np.float32, "F16": np.float16, "BF16": np.int16, "I64": np.int64, "I32": np.int32}
_CODES = {
    torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32",
}
_MAX_HEADER = 100 << 20


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors in the file's dtypes."""
    path = Path(path)
    data = path.read_bytes()
    size = len(data)
    if size < 8:
        raise ValueError(f"{path}: {size} bytes, too short for a safetensors header length")
    (n,) = struct.unpack("<Q", data[:8])
    if n > size - 8 or n > _MAX_HEADER:
        raise ValueError(f"{path}: header length {n} runs past the end of the {size}-byte file")
    try:
        header = json.loads(data[8 : 8 + n].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ValueError(f"{path}: the header is not JSON ({exc})") from exc
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    body = memoryview(data)[8 + n :]
    out: dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        try:
            code, shape, (begin, end) = meta["dtype"], list(meta["shape"]), meta["data_offsets"]
        except (KeyError, TypeError, ValueError) as exc:
            raise ValueError(f"{path}: tensor {name!r} has a malformed entry {meta!r}") from exc
        if code not in _NUMPY:
            raise ValueError(f"{path}: tensor {name!r} has dtype {code!r}, not one of {sorted(_NUMPY)}")
        np_dtype = np.dtype(_NUMPY[code]).newbyteorder("<")
        if not 0 <= begin <= end <= len(body):
            raise ValueError(
                f"{path}: tensor {name!r} has offsets [{begin}, {end}] outside the "
                f"{len(body)}-byte data buffer"
            )
        if end - begin != math.prod(shape) * np_dtype.itemsize:
            raise ValueError(
                f"{path}: tensor {name!r} spans {end - begin} bytes, not the "
                f"{math.prod(shape) * np_dtype.itemsize} of {code} {shape}"
            )
        arr = np.frombuffer(body[begin:end], dtype=np_dtype).astype(np_dtype.newbyteorder("="))
        tensor = torch.from_numpy(arr.reshape(shape))
        out[name] = tensor.view(torch.bfloat16) if code == "BF16" else tensor
    return out


def save_file(tensors: Mapping[str, torch.Tensor | np.ndarray], path: str | Path) -> None:
    """Write ``tensors`` (CPU tensors or numpy arrays) as one safetensors file.

    Tensors are laid out in name order; the file is written to a sibling
    temporary file and renamed over ``path``.
    """
    path = Path(path)
    header: dict[str, object] = {}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        value = tensors[name]
        t = torch.from_numpy(np.array(value, order="C")) if isinstance(value, np.ndarray) else value
        t = t.detach().to("cpu").contiguous()
        if t.dtype not in _CODES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} is not one of {sorted(_CODES.values())}")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)  # 8-byte aligned data, as the package writes it
    tmp = path.with_name(path.name + ".tmp")
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(text)))
            f.write(text)
            for raw in blobs:
                f.write(raw)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
