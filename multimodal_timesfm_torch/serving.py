"""Serving export: a ``torch.export`` program or an AOTInductor package, weights beside it.

Counterpart of the JAX package's two serving formats: the StableHLO artifact
(``serving.py:236-412``: ``export_stablehlo``, ``load_stablehlo``,
``save_stablehlo_params``) and the TF SavedModel (``export_saved_model``,
``serving.py:39``). An artifact directory holds:

  * the forecast pipeline (preprocess -> fusion -> backbone -> postprocess)
    traced by ``torch.export`` as a function of ``(params, context[,
    text_embeddings])``, the batch dimension symbolic, context and horizon
    static, masks all-valid, as in JAX. Its outputs are ``point_forecast``,
    plus ``full_forecast`` with ``full_outputs``. In one of two formats:

    - ``program`` (StableHLO's counterpart): ``program.pt2``, the
      ``ExportedProgram`` itself, served by interpreting its graph;
    - ``aoti`` (the SavedModel's counterpart): ``package.pt2``, the same
      program compiled ahead of time by AOTInductor
      (``torch._inductor.aoti_compile_and_package``) into a shared library
      for the device it was traced on (Triton for the fused elementwise work
      and cuBLAS for the GEMMs on the card, C++ on the CPU), served from
      C++;
  * ``params.npz``: the weights, outside the program for JAX's reasons (the
    program stays small, and a fine-tune re-points either format with
    :func:`save_program_params`): raw-byte leaves keyed by the port's
    parameter names, bf16 kept as its 2-byte data, read with
    ``allow_pickle=False``;
  * ``manifest.json``: JAX's keys, ``"format"`` ``"torch.export"`` or
    ``"aoti"``; a package's ``"platforms"`` names the one device type it
    was compiled for.

The kernels stay in the artifact. JAX's export forces XLA attention because
Pallas is not portable across platforms; here the traced graph holds the
port's attention custom ops (``torch.ops.mtt.*``, traced under
``ops.attention.kernel_route``). A program exported on the CPU launches the
Hopper kernels when it is served on the card (it is moved with
``torch.export.passes.move_to_device_pass``) and serves with their plain
versions on the CPU. The custom ops are opaque to Inductor, so a package
calls them through PyTorch's dispatcher by name, and any process that has
them registered serves it: a Python process that has imported the modules
registering them, which :func:`load_program` does, or ``mtt_serve``, a
libtorch program with no Python in it that loads their C++ registration
(``csrc/mtt_serve.cpp``, ``csrc/mtt_ops.cpp``, built and driven by
``native.py``), as TF Serving serves JAX's SavedModel. Either way the
hand-written kernels launch from inside the package. A package
is tolerance-equal to the eager model, not bit-equal, since Inductor fuses
and reorders the elementwise work. :func:`load_program` imports torch, numpy
and the op modules, and no model code.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

from multimodal_timesfm_torch.utils.logging import get_logger
from multimodal_timesfm_torch.utils.platform import resolve_device

_logger = get_logger()

_PROGRAM_FILE = "program.pt2"
_PACKAGE_FILE = "package.pt2"
# The export formats (the CLI's --format) and the manifest's name for each.
FORMATS = {"program": "torch.export", "aoti": "aoti"}
_PARAMS_FILE = "params.npz"
_MANIFEST_FILE = "manifest.json"
# dtype name -> (numpy dtype of the raw bytes, torch dtype)
_DTYPES = {
    "float32": (np.float32, torch.float32),
    "bfloat16": (np.int16, torch.bfloat16),
    "float16": (np.float16, torch.float16),
    "int64": (np.int64, torch.int64),
    "int32": (np.int32, torch.int32),
    "bool": (np.bool_, torch.bool),
}


def _register_ops() -> None:
    """Import the modules that register the ``torch.ops.mtt`` custom ops the program calls."""
    from multimodal_timesfm_torch.ops import attention, chronos_attention, qkv_attention  # noqa: F401


def _named_tensors(params: Any) -> dict[str, torch.Tensor]:
    """A module's parameters and buffers by name, or a name -> tensor mapping as it is."""
    if isinstance(params, torch.nn.Module):
        return {name: t.detach() for name, t in (*params.named_parameters(), *params.named_buffers())}
    return {name: t.detach() for name, t in params.items()}


def _leaf_spec(tensors: Mapping[str, torch.Tensor]) -> dict[str, dict]:
    return {
        name: {"shape": list(t.shape), "dtype": str(t.dtype).removeprefix("torch.")}
        for name, t in tensors.items()
    }


def _raw_leaves(tensors: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Each tensor's bytes as a uint8 array (``np.savez`` would degrade a bf16 leaf)."""
    out = {}
    for name, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[name] = t.numpy().reshape(-1).view(np.uint8)
    return out


def _write_npz_atomic(path: Path, leaves: Mapping[str, np.ndarray]) -> None:
    """Write ``leaves`` to ``path`` through a same-directory temporary file and a rename,
    so a failed write leaves the previous weights whole and no ``*.tmp`` behind."""
    tmp = path.with_name(path.name + ".tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **leaves)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _read_params(npz: Any, leaf_spec: Mapping[str, dict]) -> dict[str, torch.Tensor]:
    params = {}
    for name, meta in leaf_spec.items():
        np_dtype, dtype = _DTYPES[meta["dtype"]]
        raw = npz[name]  # a fresh uint8 array read from the archive
        if raw.dtype != np.uint8 or raw.ndim != 1:
            raise ValueError(f"params leaf {name!r} is not raw bytes")
        t = torch.from_numpy(raw.view(np_dtype).reshape(meta["shape"]))
        params[name] = t.view(torch.bfloat16) if dtype == torch.bfloat16 else t
    return params


class _Outputs(torch.nn.Module):
    """The decoder's outputs at one horizon: ``point_forecast``[, ``full_forecast``]."""

    def __init__(self, decoder: Any, horizon: int, full_outputs: bool) -> None:
        super().__init__()
        self.decoder, self.horizon, self.full_outputs = decoder, horizon, full_outputs

    def forward(self, context: torch.Tensor, masks: torch.Tensor,
                text: torch.Tensor | None) -> dict[str, torch.Tensor]:
        out = {"point_forecast": self.decoder(self.horizon, context, masks, text)}
        if self.full_outputs:
            out["full_forecast"] = self.decoder.forward_full(self.horizon, context, masks, text)
        return out


class _Pipeline(torch.nn.Module):
    """``(params, context[, text]) -> outputs`` through ``torch.func.functional_call``; the
    decoder is held outside the module tree, so the program lifts no weights of its own."""

    def __init__(self, decoder: Any, horizon: int, multimodal: bool, full_outputs: bool) -> None:
        super().__init__()
        object.__setattr__(self, "outputs", _Outputs(decoder, horizon, full_outputs))
        self.multimodal = multimodal

    def forward(self, params: dict[str, torch.Tensor], context: torch.Tensor,
                text_embeddings: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        masks = torch.zeros_like(context, dtype=torch.bool)
        text = text_embeddings if self.multimodal else None
        weights = {f"decoder.{name}": t for name, t in params.items()}
        return torch.func.functional_call(self.outputs, weights, (context, masks, text))


@contextlib.contextmanager
def _unpacked(adapter: Any):
    """Trace a Chronos-2 adapter with ``pack=1``. Packing series into one encoder row is a
    throughput device, numerically the same as ``pack=1``, and a packed program would take
    only batches in multiples of ``pack``."""
    cfg = adapter.config
    if getattr(cfg, "pack", 1) == 1:
        yield
        return
    adapter.config = dataclasses.replace(cfg, pack=1)
    try:
        yield
    finally:
        adapter.config = cfg


def export_program(
    decoder: Any,
    horizon: int,
    context_len: int,
    output_dir: str | Path,
    multimodal: bool = False,
    full_outputs: bool = False,
    format: str = "program",
) -> Path:
    """Export the forecast pipeline (JAX ``export_stablehlo``, or ``export_saved_model``).

    Traced on the decoder's device with its weights as the ``params`` input
    (a dict keyed by the decoder's parameter names) and a symbolic batch;
    the weights are written to ``params.npz``, not into the program.
    ``format`` is ``"program"`` (the ``ExportedProgram``) or ``"aoti"`` (it
    compiled by AOTInductor for the decoder's device, which is the only
    device the package serves on). :func:`load_program` serves either.
    """
    from torch.export import Dim

    from multimodal_timesfm_torch.ops.attention import kernel_route

    if format not in FORMATS:
        raise ValueError(f"unknown export format {format!r}; expected one of {sorted(FORMATS)}")
    device = next(decoder.parameters()).device
    params = _named_tensors(decoder)
    patch = decoder.adapter.patch_len
    num_patches = context_len // patch
    text_dims = decoder.fusion_spec.text_embedding_dims
    example = 2
    args: tuple[Any, ...] = (params, torch.zeros(example, context_len, device=device))
    batch = Dim("batch", min=1, max=1 << 20)
    shapes: tuple[Any, ...] = ({name: None for name in params}, {0: batch})
    if multimodal:
        args += (torch.zeros(example, num_patches, text_dims, device=device),)
        shapes += ({0: batch},)
    pipeline = _Pipeline(decoder, horizon, multimodal, full_outputs)
    with torch.no_grad(), kernel_route(), _unpacked(decoder.adapter):
        program = torch.export.export(pipeline, args, dynamic_shapes=shapes, strict=False)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    if format == "aoti":
        from torch._inductor import aoti_compile_and_package

        # Inductor compiles against the example inputs; the package does not keep them. It
        # keeps a fused chain of low-precision ops in fp32 unless told to round where each op
        # rounds, as the eager model does (a bf16 Chronos-2 drifts 0.2 x std from it otherwise).
        aoti_compile_and_package(program, package_path=str(output_dir / _PACKAGE_FILE),
                                 inductor_configs={"emulate_precision_casts": True})
    else:
        # The example inputs hold the weights: saved with the program they would double the
        # artifact and defeat keeping the weights outside it.
        program.example_inputs = None
        torch.export.save(program, output_dir / _PROGRAM_FILE)
    _write_npz_atomic(output_dir / _PARAMS_FILE, _raw_leaves(params))
    (output_dir / _MANIFEST_FILE).write_text(json.dumps({
        "format": FORMATS[format],
        "horizon": horizon,
        "context_len": context_len,
        "num_patches": num_patches,
        "text_dims": text_dims,
        "multimodal": multimodal,
        "full_outputs": full_outputs,
        # A program serves on either device; a package on the one it was compiled for.
        "platforms": [device.type] if format == "aoti" else ["cpu", "cuda"],
        "leaf_spec": _leaf_spec(params),
        "list_lens": {},
    }, indent=2))
    _logger.info(
        "Exported %s artifact to %s (horizon=%d, context=%d, multimodal=%s, full=%s, traced on %s)",
        FORMATS[format], output_dir, horizon, context_len, multimodal, full_outputs, device,
    )
    return output_dir


def load_program(artifact_dir: str | Path, device: str | torch.device | None = None) -> tuple[Callable, dict]:
    """Load an :func:`export_program` artifact of either format into a serving callable (JAX
    ``load_stablehlo``).

    Returns ``(serve_fn, manifest)``; ``serve_fn(context[, text_embeddings])``
    takes arrays or tensors with any batch size and returns the program's
    output dict of tensors on ``device``. ``device`` is CUDA unless the
    caller passes another (the CPU serves with the kernels' plain versions).
    A program serves on any device; a package only on the device type it
    was compiled for, and another raises. The weights go to the device once,
    here. No pickle is read and no model code is imported.
    """
    _register_ops()
    device = resolve_device(device)
    artifact_dir = Path(artifact_dir)
    manifest = json.loads((artifact_dir / _MANIFEST_FILE).read_text())
    if manifest.get("format") == "aoti":
        if device.type not in manifest["platforms"]:
            raise ValueError(
                f"{artifact_dir} holds an AOTInductor package compiled for {manifest['platforms']}; it "
                f"cannot serve on {device.type!r} (export it again on that device)"
            )
        from torch._inductor import aoti_load_package

        index = -1 if device.index is None else device.index  # -1: the current device
        module = aoti_load_package(str(artifact_dir / _PACKAGE_FILE), device_index=index)
    elif manifest.get("format") == "torch.export":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(torch.export.load(artifact_dir / _PROGRAM_FILE), device)
        module = program.module()
    else:
        raise ValueError(f"{artifact_dir} holds a {manifest.get('format')!r} artifact, not one of "
                         f"{sorted(FORMATS.values())}")
    with np.load(artifact_dir / _PARAMS_FILE, allow_pickle=False) as npz:
        params = {k: v.to(device) for k, v in _read_params(npz, manifest["leaf_spec"]).items()}

    def stage(x: Any) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x,
                               dtype=torch.float32, device=device)

    def serve_fn(context: Any, text_embeddings: Any = None) -> dict[str, torch.Tensor]:
        args = [params, stage(context)]
        if manifest["multimodal"]:
            if text_embeddings is None:
                raise ValueError("this artifact was exported multimodal: pass text_embeddings")
            args.append(stage(text_embeddings))
        with torch.inference_mode():
            return module(*args)

    return serve_fn, manifest


def save_program_params(artifact_dir: str | Path, params: Any) -> None:
    """Re-point an exported artifact of either format at new weights (JAX ``save_stablehlo_params``).

    ``params`` is a decoder (its parameters and buffers) or a name -> tensor
    mapping. It is checked against the manifest's leaf spec before anything
    is written, since the program was traced for exactly those shapes and
    dtypes; the write is atomic.
    """
    artifact_dir = Path(artifact_dir)
    tensors = _named_tensors(params)
    leaf_spec = _leaf_spec(tensors)
    manifest = json.loads((artifact_dir / _MANIFEST_FILE).read_text())
    old_spec = manifest["leaf_spec"]
    if leaf_spec != old_spec:
        missing = sorted(set(old_spec) - set(leaf_spec))
        extra = sorted(set(leaf_spec) - set(old_spec))
        changed = sorted(k for k in set(leaf_spec) & set(old_spec) if leaf_spec[k] != old_spec[k])
        detail = "; ".join(
            f"{label}: {names[:5]}{'...' if len(names) > 5 else ''}"
            for label, names in (
                ("missing leaves", missing),
                ("unexpected leaves", extra),
                ("shape/dtype mismatches", changed),
            )
            if names
        )
        raise ValueError(
            f"params do not match the exported program's spec ({detail}). The program was "
            "traced for the exported shapes/dtypes — re-export with export_program instead "
            "of re-pointing."
        )
    _write_npz_atomic(artifact_dir / _PARAMS_FILE, _raw_leaves(tensors))
