"""Pretrained backbone checkpoint -> JAX-layout params tree, for the bridge to load.

Counterpart of ``multimodal_timesfm_tpu/models/convert.py``, rule for rule.
Nothing is downloaded; loading reads a *local* directory or file:

  * a snapshot directory holding ``model.safetensors`` (read by the port's
    own reader, ``utils/safetensors.py``) or ``pytorch_model.bin`` (read with
    ``torch.load(weights_only=True)``);
  * a ``.ckpt``/``.pkl`` pickle of a params tree written by this port or by
    the JAX package (read by the restricted unpickler of
    ``training/checkpoint.py``).

Upstream tensor names map through :data:`TIMESFM_NAME_RULES` and
:data:`CHRONOS_NAME_RULES`, the JAX package's rules copied candidate for
candidate: torch (out, in) weights are transposed to (in, out) kernels,
per-layer tensors are stacked on a leading axis, separate q/k/v projections
are concatenated in q;k;v order, an RMS gain stored in the weight convention
is shifted to the port's ``1 + scale`` (detected by a mean above 0.5, and
logged), and names may carry a ``model.`` or ``module.`` prefix. As in JAX,
the rules were written against the module structure and have not yet been
checked against a real upstream snapshot.

The result is a numpy tree in the JAX layout (fp32); ``bridge.load_jax_params``
puts it into a module. Loading is strict: a leaf no rule fills, or one of the
wrong shape, raises ``ValueError``; an upstream tensor no rule consumes is
logged as a warning, as in JAX.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from multimodal_timesfm_torch.models.base import TsfmAdapter
from multimodal_timesfm_torch.models.bridge import expected_shapes, jax_tree_arrays, leaf_array
from multimodal_timesfm_torch.utils import safetensors
from multimodal_timesfm_torch.utils.logging import get_logger

_logger = get_logger()

Rules = list[tuple[str, list[tuple[str, str]]]]


def _numpy(sd: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Tensors -> numpy; bf16 (which numpy lacks) upcast to fp32, which is exact."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in sd.items()}


def _load_safetensors(path: Path) -> dict[str, np.ndarray]:
    return _numpy(safetensors.load_file(path))


def _load_torch_bin(path: Path) -> dict[str, np.ndarray]:
    return _numpy(torch.load(path, map_location="cpu", weights_only=True))


def load_backbone_checkpoint(path: str | Path, adapter: TsfmAdapter) -> dict[str, Any]:
    """Backbone params (a JAX-layout numpy tree) from a local checkpoint directory or file.

    Takes every layout ``snapshot.resolve_snapshot_dir`` resolves:
    ``model.safetensors`` or ``pytorch_model.bin`` snapshots, and ``.ckpt``/
    ``.pkl`` pickles of a params tree (the port's or the JAX package's).
    """
    from multimodal_timesfm_torch.training.checkpoint import load_checkpoint

    path = Path(path)
    if path.is_dir():
        st = path / "model.safetensors"
        if st.exists():
            return convert_safetensors(_load_safetensors(st), adapter)
        bin_path = path / "pytorch_model.bin"
        if bin_path.exists():
            return convert_safetensors(_load_torch_bin(bin_path), adapter)
        candidates = sorted(path.glob("*.ckpt")) + sorted(path.glob("*.pkl"))
        if not candidates:
            raise FileNotFoundError(
                f"No model.safetensors, pytorch_model.bin, or .ckpt/.pkl under {path}"
            )
        if len(candidates) > 1:
            _logger.warning(
                "Multiple checkpoints under %s; loading %s (lexicographically first — pass "
                "the file path directly to pick another)", path, candidates[0].name,
            )
        path = candidates[0]
    if path.suffix == ".safetensors":
        return convert_safetensors(_load_safetensors(path), adapter)
    if path.suffix == ".bin":
        return convert_safetensors(_load_torch_bin(path), adapter)
    payload = load_checkpoint(path)
    if isinstance(payload, dict) and "adapter_params" not in payload and (
        "fusion_params" in payload or "optimizer_state" in payload
    ):
        raise ValueError(
            f"{path} is a training checkpoint without backbone weights "
            "(multimodal mode saves fusion_params only) — point at a baseline "
            "checkpoint carrying adapter_params, or at a pretrained snapshot."
        )
    params = payload.get("adapter_params", payload) if isinstance(payload, dict) else payload
    jax_tree_arrays(adapter, params)  # strict: raises on a missing, extra or misshapen leaf
    return _fp32_tree(params)


def _fp32_tree(node: Any) -> Any:
    """The same tree with every leaf an fp32 numpy array."""
    if isinstance(node, dict):
        return {k: _fp32_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_fp32_tree(v) for v in node]
    return leaf_array(node).astype(np.float32)


def convert_safetensors(sd: dict[str, np.ndarray], adapter: TsfmAdapter) -> dict[str, Any]:
    """Map an upstream state dict onto the adapter's JAX-layout tree (strict)."""
    from multimodal_timesfm_torch.models.chronos import Chronos2Adapter
    from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter

    if isinstance(adapter, TimesFM2p5Adapter):
        return _convert_with_rules(sd, adapter, TIMESFM_NAME_RULES)
    if isinstance(adapter, Chronos2Adapter):
        return _convert_with_rules(sd, adapter, CHRONOS_NAME_RULES)
    raise NotImplementedError(type(adapter).__name__)


# Rules: (tree-path regex) -> upstream-name candidates, tried in order, each
# (name template, transform). {i} is the stacked-layer index; {p} in a
# "split" transform expands to q/k/v. Transforms: "t" transposes a torch
# (out, in) weight to an (in, out) kernel; "" takes the tensor as it is;
# "rms" subtracts 1 from an RMS gain whose mean exceeds 0.5 (a weight-
# convention gain; the port applies 1 + scale); "split_t"/"split_b" gather
# separate q/k/v projections into the fused qkv kernel/bias (q;k;v order,
# as the (3, heads, head_dim) reshape of models/layers.py reads them).


def _residual_block_rules(
    ours: str,
    theirs: str,
    hidden: tuple[str, ...] = ("hidden_layer.0", "input_layer", "hidden_layer"),
) -> Rules:
    """Rules for one upstream ResidualBlock; ``hidden`` orders the inner-layer name
    candidates (precedence only matters where several aliases coexist)."""

    def cands(inner, suffix: str, transform: str):
        return [(f"{theirs}.{n}.{suffix}", transform) for n in inner]

    return [
        (rf"{ours}/hidden/kernel", cands(hidden, "weight", "t")),
        (rf"{ours}/hidden/bias", cands(hidden, "bias", "")),
        (rf"{ours}/output/kernel", cands(["output_layer"], "weight", "t")),
        (rf"{ours}/output/bias", cands(["output_layer"], "bias", "")),
        (rf"{ours}/residual/kernel", cands(["residual_layer"], "weight", "t")),
        (rf"{ours}/residual/bias", cands(["residual_layer"], "bias", "")),
    ]


TIMESFM_NAME_RULES: Rules = [
    *_residual_block_rules("tokenizer", "tokenizer"),
    (r"stacked_xf/attn_norm/scale", [("stacked_xf.{i}.input_layernorm.weight", "rms")]),
    (
        r"stacked_xf/attn/qkv/kernel",
        [
            ("stacked_xf.{i}.self_attn.qkv_proj.weight", "t"),
            ("stacked_xf.{i}.self_attn.{p}_proj.weight", "split_t"),
        ],
    ),
    (
        r"stacked_xf/attn/qkv/bias",
        [
            ("stacked_xf.{i}.self_attn.qkv_proj.bias", ""),
            ("stacked_xf.{i}.self_attn.{p}_proj.bias", "split_b"),
        ],
    ),
    (r"stacked_xf/attn/out/kernel", [("stacked_xf.{i}.self_attn.o_proj.weight", "t")]),
    (r"stacked_xf/attn/out/bias", [("stacked_xf.{i}.self_attn.o_proj.bias", "")]),
    (r"stacked_xf/attn/per_dim_scale", [("stacked_xf.{i}.self_attn.scaling", "")]),
    (r"stacked_xf/ffn_norm/scale", [("stacked_xf.{i}.mlp.layer_norm.weight", "")]),
    (r"stacked_xf/ffn_norm/bias", [("stacked_xf.{i}.mlp.layer_norm.bias", "")]),
    (r"stacked_xf/ffn_up/kernel", [("stacked_xf.{i}.mlp.gate_proj.weight", "t")]),
    (r"stacked_xf/ffn_up/bias", [("stacked_xf.{i}.mlp.gate_proj.bias", "")]),
    (r"stacked_xf/ffn_down/kernel", [("stacked_xf.{i}.mlp.down_proj.weight", "t")]),
    (r"stacked_xf/ffn_down/bias", [("stacked_xf.{i}.mlp.down_proj.bias", "")]),
    *_residual_block_rules("output_projection_point", "output_projection_point"),
    *_residual_block_rules("output_projection_quantiles", "output_projection_quantiles"),
]

# Chronos checkpoints favour the plain "hidden_layer" alias first.
_CHRONOS_HIDDEN = ("hidden_layer", "input_layer", "hidden_layer.0")

CHRONOS_NAME_RULES: Rules = [
    *_residual_block_rules("input_patch_embedding", "input_patch_embedding", _CHRONOS_HIDDEN),
    (r"shared", [("shared.weight", "")]),
    (
        r"encoder/rel_pos_bias",
        [("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight", "")],
    ),
    (r"encoder/final_norm/scale", [("encoder.final_layer_norm.weight", "rms")]),
    (r"encoder/layers/attn_norm/scale", [("encoder.block.{i}.layer.0.layer_norm.weight", "rms")]),
    (r"encoder/layers/attn/q/kernel", [("encoder.block.{i}.layer.0.SelfAttention.q.weight", "t")]),
    (r"encoder/layers/attn/k/kernel", [("encoder.block.{i}.layer.0.SelfAttention.k.weight", "t")]),
    (r"encoder/layers/attn/v/kernel", [("encoder.block.{i}.layer.0.SelfAttention.v.weight", "t")]),
    (r"encoder/layers/attn/out/kernel", [("encoder.block.{i}.layer.0.SelfAttention.o.weight", "t")]),
    (r"encoder/layers/ffn_norm/scale", [("encoder.block.{i}.layer.1.layer_norm.weight", "rms")]),
    (r"encoder/layers/ffn_up/kernel", [("encoder.block.{i}.layer.1.DenseReluDense.wi.weight", "t")]),
    (r"encoder/layers/ffn_down/kernel", [("encoder.block.{i}.layer.1.DenseReluDense.wo.weight", "t")]),
    *_residual_block_rules("output_patch_embedding", "output_patch_embedding", _CHRONOS_HIDDEN),
]

_PREFIXES = ("", "model.", "module.")


def _convert_with_rules(sd: dict[str, np.ndarray], adapter: TsfmAdapter, rules: Rules) -> dict[str, Any]:
    # The adapter's tree paths in JAX's flattening order (keys sorted level by level).
    template = sorted(expected_shapes(adapter).items(), key=lambda item: item[0].split("/"))
    used: set[str] = set()

    def lookup(name: str, attempt: set[str]) -> np.ndarray | None:
        for pre in _PREFIXES:
            if pre + name in sd:
                attempt.add(pre + name)
                return sd[pre + name]
        return None

    def fetch(name_tpl: str, transform: str, i: int | None, attempt: set[str]) -> np.ndarray | None:
        """One candidate (for layer i when templated), transformed."""
        fmt = {"i": i} if i is not None else {}
        if transform.startswith("split_"):
            parts = [lookup(name_tpl.format(p=p, **fmt), attempt) for p in ("q", "k", "v")]
            if any(p is None for p in parts):
                return None
            if transform == "split_t":  # (out, in) weights -> fused (in, 3 * out)
                return np.concatenate([p.T for p in parts], axis=1)
            return np.concatenate(parts, axis=0)
        arr = lookup(name_tpl.format(**fmt), attempt)
        if arr is None:
            return None
        if transform == "t":
            return arr.T
        if transform == "rms":
            # Only a positive mean marks the weight convention: a strongly
            # negative mean is a drifted zero-centred scale, and subtracting 1
            # from it would invert activations.
            mean = float(np.mean(arr))
            if mean > 0.5:
                _logger.info(
                    "RMSNorm %s: weight-convention detected (mean %.3f); storing weight - 1",
                    name_tpl.format(**fmt), mean,
                )
                return arr - 1.0
        return arr

    def resolve(candidates: list[tuple[str, str]], shape: tuple[int, ...]) -> np.ndarray | None:
        for name_tpl, transform in candidates:
            # A candidate's tensors count as used only if the whole candidate
            # succeeds, so a partial match that falls through keeps them in the
            # unconsumed-tensor warning.
            attempt: set[str] = set()
            if "{i}" in name_tpl:
                per_layer = [fetch(name_tpl, transform, i, attempt) for i in range(shape[0])]
                if all(p is not None for p in per_layer):
                    used.update(attempt)
                    return np.stack(per_layer)
            else:
                value = fetch(name_tpl, transform, None, attempt)
                if value is not None:
                    used.update(attempt)
                    return value
        return None

    tree: dict[str, Any] = {}
    unmatched: list[str] = []
    for key, shape in template:
        rule = next((r for r in rules if re.fullmatch(r[0], key)), None)
        value = resolve(rule[1], shape) if rule is not None else None
        if value is None:
            unmatched.append(key)
            continue
        if value.shape != shape:
            raise ValueError(f"{key}: checkpoint shape {value.shape} != expected {shape}")
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.ascontiguousarray(value, dtype=np.float32)

    if unmatched:
        raise ValueError(
            "Strict conversion failed; unmatched template leaves: " + ", ".join(unmatched[:20])
        )
    unused = set(sd) - used
    if unused:
        _logger.warning("Checkpoint tensors not consumed: %s", sorted(unused)[:20])
    return tree
