"""Checkpoint persistence: save, load and rotate, with the JAX package's policies.

Counterpart of ``multimodal_timesfm_tpu/training/checkpoint.py``. A payload
is a dict of host values (numpy trees in JAX layout, Python scalars);
tensors are pulled to host numpy on save (bf16 as fp32, which is exact). Epoch checkpoints are
``checkpoint_epoch_<n>.ckpt`` with ``save_total_limit`` rotation, the best one
is ``best_model.ckpt``. Two backends:

  * ``pickle`` (the default): one pickle file, as JAX writes it;
  * ``orbax``: the counterpart of JAX's orbax directory, without orbax: a
    directory holding the arrays as one safetensors file
    (``utils/safetensors.py``) and the tree's structure and scalars as JSON.
    It is written to a sibling temporary directory and renamed. A directory
    that JAX's orbax wrote is refused by name: reading orbax's own format is
    not ported.

:func:`load_checkpoint` reads either backend, and pickles written by the JAX
package too, through a restricted unpickler: it rebuilds numpy arrays and
scalars, containers, and the optax state classes a JAX trainer stores
(:class:`EmptyState`, :class:`ScaleByAdamState`, :class:`ScaleByScheduleState`,
here as stand-ins with the same fields; neither optax nor JAX is imported).
bf16 arrays (``ml_dtypes.bfloat16``, the JAX trainer's bf16 Adam moments)
come back as ``torch.bfloat16`` tensors holding the same 2-byte data. Any
other global a file names raises ``pickle.UnpicklingError`` naming it, so a
foreign file cannot run code on load.
"""

from __future__ import annotations

import json
import pickle
import shutil
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

from multimodal_timesfm_torch.utils import safetensors
from multimodal_timesfm_torch.utils.logging import get_logger

_logger = get_logger()

CKPT_SUFFIX = ".ckpt"
BACKENDS = ("pickle", "orbax")
_TREE_FILE = "tree.json"
_ARRAYS_FILE = "arrays.safetensors"
_FORMAT = "multimodal_timesfm_torch.checkpoint"
# Files that mark a directory written by orbax (the JAX package's orbax backend).
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "_sharding", "checkpoint")


class EmptyState(NamedTuple):
    """Stand-in for ``optax.EmptyState``."""


class ScaleByAdamState(NamedTuple):
    """Stand-in for ``optax.ScaleByAdamState``: the step count and the two moment trees."""

    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    """Stand-in for ``optax.ScaleByScheduleState``: the schedule's step count."""

    count: Any


class _Bfloat16:
    """Stand-in for ``ml_dtypes.bfloat16``, the scalar type a pickled bf16 dtype names."""


class _Bf16Dtype:
    """What unpickling ``numpy.dtype(bfloat16)`` gives here: a marker (numpy has no bf16)."""

    def __setstate__(self, state: Any) -> None:
        pass


class _PendingArray:
    """An ndarray that ``numpy._core.multiarray._reconstruct`` started; the pickle's BUILD
    hands it the state, and :func:`_finish` swaps it for the array."""

    value: Any = None

    def __setstate__(self, state: tuple) -> None:
        _, shape, dtype, is_fortran, raw = state
        self.value = _array(raw, dtype, shape, "F" if is_fortran else "C")


def _check_dtype(dtype: Any) -> None:
    if isinstance(dtype, np.dtype) and dtype.hasobject:
        raise pickle.UnpicklingError("an array of Python objects is refused")


def _array(raw: Any, dtype: Any, shape: Any, order: str) -> np.ndarray | torch.Tensor:
    """The array of ``raw`` bytes; bf16 becomes a ``torch.bfloat16`` tensor."""
    if isinstance(dtype, _Bf16Dtype):
        bits = np.frombuffer(raw, dtype=np.int16).reshape(shape, order=order).copy(order="C")
        return torch.from_numpy(bits).view(torch.bfloat16)
    _check_dtype(dtype)
    if not isinstance(raw, (bytes, bytearray, memoryview, pickle.PickleBuffer)):
        raise pickle.UnpicklingError(f"array data of type {type(raw).__name__} is refused")
    return np.frombuffer(raw, dtype=dtype).reshape(shape, order=order).copy(order="K")


def _reconstruct(subtype: Any, shape: Any, code: Any) -> _PendingArray:
    if subtype is not np.ndarray:
        raise pickle.UnpicklingError(f"ndarray subclass {subtype!r} is refused")
    return _PendingArray()


def _frombuffer(
    buf: Any, dtype: Any, shape: Any, order: str, axis_order: Any = None
) -> np.ndarray | torch.Tensor:
    """numpy's ``_frombuffer``. A numpy that pickles an array whose strides permute its
    axes (a stack of transposed kernels, say) without a copy passes order "K", the shape
    in memory order and the axis order that permutes it back."""
    if order != "K" or axis_order is None:
        return _array(buf, dtype, shape, order)
    arr = _array(buf, dtype, shape, "C")
    if isinstance(arr, torch.Tensor):
        return arr.permute(*axis_order).contiguous()
    return np.ascontiguousarray(arr.transpose(axis_order))


def _scalar(dtype: Any, raw: bytes) -> Any:
    if isinstance(dtype, _Bf16Dtype):
        return _array(raw, dtype, (), "C")
    _check_dtype(dtype)
    return np.frombuffer(raw, dtype=dtype)[0]


def _dtype(obj: Any, align: bool = False, copy: bool = False) -> np.dtype | _Bf16Dtype:
    if obj is _Bfloat16:
        return _Bf16Dtype()
    dtype = np.dtype(obj, align, copy)
    _check_dtype(dtype)
    return dtype


_ALLOWED: dict[tuple[str, str], Any] = {
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): _dtype,
    ("ml_dtypes", "bfloat16"): _Bfloat16,
    ("optax._src.base", "EmptyState"): EmptyState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.transform", "ScaleByScheduleState"): ScaleByScheduleState,
}
for _core in ("numpy.core", "numpy._core"):  # numpy 1.x and 2.x paths
    _ALLOWED[(f"{_core}.multiarray", "_reconstruct")] = _reconstruct
    _ALLOWED[(f"{_core}.multiarray", "scalar")] = _scalar
    _ALLOWED[(f"{_core}.numeric", "_frombuffer")] = _frombuffer


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        try:
            return _ALLOWED[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"checkpoint names {module}.{name}, which is not an allowed global "
                "(numpy arrays and scalars, bf16, optax's Adam states, plain containers)"
            ) from None


def _finish(node: Any) -> Any:
    """Swap every :class:`_PendingArray` of an unpickled tree for its array."""
    if isinstance(node, _PendingArray):
        return node.value
    if isinstance(node, dict):
        return {k: _finish(v) for k, v in node.items()}
    if isinstance(node, tuple):
        items = [_finish(v) for v in node]
        return type(node)(*items) if hasattr(node, "_fields") else tuple(items)
    if isinstance(node, list):
        return [_finish(v) for v in node]
    return node


def _to_host(node: Any) -> Any:
    if isinstance(node, torch.Tensor):
        node = node.detach().cpu()
        return (node.float() if node.dtype == torch.bfloat16 else node).numpy()
    if isinstance(node, dict):
        return {key: _to_host(value) for key, value in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_host(value) for value in node)
    return node


# -- the directory backend: arrays in safetensors, the rest in JSON --


def _encode(node: Any, path: str, arrays: dict[str, Any]) -> Any:
    if isinstance(node, dict):
        for key in node:
            if not isinstance(key, str) or "/" in key:
                raise ValueError(f"checkpoint key {key!r} under {path or '<root>'!r} is not a plain string")
        return {"dict": {k: _encode(v, f"{path}/{k}" if path else k, arrays) for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_encode(v, f"{path}/{i}", arrays) for i, v in enumerate(node)]}
    if isinstance(node, (np.ndarray, np.generic, torch.Tensor)):
        arrays[path] = np.asarray(node) if isinstance(node, np.generic) else node
        return {"array": path}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    raise ValueError(f"checkpoint leaf {path!r} of type {type(node).__name__} cannot be stored")


def _decode(node: dict, arrays: dict[str, torch.Tensor]) -> Any:
    (kind, value), = node.items()
    if kind == "dict":
        return {k: _decode(v, arrays) for k, v in value.items()}
    if kind in ("list", "tuple"):
        items = [_decode(v, arrays) for v in value]
        return items if kind == "list" else tuple(items)
    if kind == "array":
        t = arrays[value]
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return value


def _save_dir(path: Path, payload: dict) -> None:
    tmp = path.with_name(path.name + ".tmp-dir")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays: dict[str, Any] = {}
    tree = _encode(payload, "", arrays)
    safetensors.save_file(arrays, tmp / _ARRAYS_FILE)
    (tmp / _TREE_FILE).write_text(json.dumps({"format": _FORMAT, "version": 1, "tree": tree}))
    if path.exists():
        shutil.rmtree(path) if path.is_dir() else path.unlink()
    tmp.rename(path)


def _load_dir(path: Path) -> dict:
    meta_file = path / _TREE_FILE
    if not meta_file.exists():
        if any((path / name).exists() for name in _ORBAX_MARKERS) or any(path.glob("*.ocdbt")):
            raise ValueError(
                f"{path} is an orbax checkpoint directory (the JAX package's orbax backend); "
                "reading orbax's format is not ported — save it with the pickle backend"
            )
        raise ValueError(f"{path} is a directory without {_TREE_FILE}: not a checkpoint")
    meta = json.loads(meta_file.read_text())
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{meta_file} is not a {_FORMAT} file")
    return _decode(meta["tree"], safetensors.load_file(path / _ARRAYS_FILE))


def save_checkpoint(path: Path | str, payload: dict, backend: str = "pickle") -> None:
    """Persist ``payload``; a crash mid-save never destroys an existing checkpoint at ``path``.

    The payload is written whole to a sibling temporary file or directory
    first, then renamed over ``path``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r}; expected one of {BACKENDS}")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    host = _to_host(payload)
    if backend == "orbax":
        _save_dir(path, host)
        return
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(host, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)


def load_checkpoint(path: Path | str) -> Any:
    """Load a checkpoint of either backend (a directory is the ``orbax`` one), or a
    pickle written by the JAX package, through the restricted unpickler."""
    path = Path(path)
    if path.is_dir():
        return _load_dir(path)
    with open(path, "rb") as f:
        return _finish(_RestrictedUnpickler(f).load())


def rotate_checkpoints(checkpoint_dir: Path, save_total_limit: int) -> None:
    """Delete the oldest epoch checkpoints beyond ``save_total_limit`` (0 deletes them all),
    files and directories alike."""
    checkpoints = sorted(
        Path(checkpoint_dir).glob(f"checkpoint_epoch_*{CKPT_SUFFIX}"),
        key=lambda p: int(p.stem.rsplit("_", 1)[-1]),
    )
    for checkpoint in checkpoints[: max(0, len(checkpoints) - save_total_limit)]:
        if checkpoint.is_dir():
            shutil.rmtree(checkpoint)
        else:
            checkpoint.unlink()
        _logger.info("Deleted old checkpoint: %s", checkpoint.name)


def adam_state(state: Any) -> tuple[int, Any, Any]:
    """(step count, mu tree, nu tree) of a stored optimizer state: the port's
    ``{"count", "mu", "nu"}`` dict, a JAX fused state (one ``ScaleByAdamState``) or a
    JAX chain state (a tuple, possibly nested, holding one ``ScaleByAdamState``)."""
    if isinstance(state, dict) and {"count", "mu", "nu"} <= set(state):
        return int(np.asarray(state["count"])), state["mu"], state["nu"]
    found = []

    def walk(node: Any) -> None:
        if isinstance(node, ScaleByAdamState):
            found.append(node)
        elif isinstance(node, tuple):
            for item in node:
                walk(item)

    walk(state)
    if len(found) != 1:
        raise ValueError(
            f"optimizer state holds {len(found)} ScaleByAdamState entries, expected one "
            f"({type(state).__name__})"
        )
    adam = found[0]
    return int(np.asarray(adam.count)), adam.mu, adam.nu
