"""HF snapshot helpers: repo-id -> local dir resolution and config.json parsing.

The port's copy of the JAX package's ``models/snapshot.py``, pointed at the
port's config classes. Nothing is downloaded:

  * :func:`resolve_snapshot_dir` turns an HF repo id (``org/name``) into a
    local snapshot path, searching (in order) an explicit path on disk, the
    ``MULTIMODAL_TIMESFM_SNAPSHOTS`` root (``$ROOT/org/name``), and the HF hub
    cache layout (``models--org--name/snapshots/<rev>``) under
    ``HF_HUB_CACHE``/``HF_HOME``/``~/.cache/huggingface``.
  * :func:`read_hf_config` loads a snapshot's ``config.json`` (if any).
  * ``*_config_from_hf`` map the config dict onto the port's config
    dataclasses, so geometry comes from the checkpoint's own metadata. Field
    aliases cover T5-style names and a nested ``chronos_config`` dict. Unknown
    fields are ignored; recognized fields override dataclass defaults.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Mapping

SNAPSHOT_ROOT_ENV = "MULTIMODAL_TIMESFM_SNAPSHOTS"

_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")


def _looks_like_snapshot(path: Path) -> bool:
    return any((path / f).exists() for f in _WEIGHT_FILES) or (path / "config.json").exists()


def _hub_cache_roots() -> list[Path]:
    roots = []
    if os.environ.get("HF_HUB_CACHE"):
        roots.append(Path(os.environ["HF_HUB_CACHE"]))
    if os.environ.get("HF_HOME"):
        roots.append(Path(os.environ["HF_HOME"]) / "hub")
    roots.append(Path.home() / ".cache" / "huggingface" / "hub")
    return roots


def resolve_snapshot_dir(path_or_repo: str | Path) -> Path:
    """Resolve a local path or an HF repo id to a local snapshot directory.

    Raises:
        FileNotFoundError: naming every location searched, so zero-egress
            users know exactly where to place a snapshot.
    """
    as_path = Path(path_or_repo)
    if as_path.exists():
        return as_path

    repo = str(path_or_repo)
    searched = [str(as_path)]
    if "/" in repo and not repo.startswith((".", "/")):
        org, name = repo.split("/", 1)
        root = os.environ.get(SNAPSHOT_ROOT_ENV)
        if root:
            candidate = Path(root) / org / name
            searched.append(str(candidate))
            if candidate.is_dir():
                return candidate
        folder = f"models--{org}--{name.replace('/', '--')}"
        for hub in _hub_cache_roots():
            base = hub / folder
            snaps = base / "snapshots"
            searched.append(str(snaps))
            if not snaps.is_dir():
                continue
            # Prefer the cache's own current-revision pointer when present.
            ref = base / "refs" / "main"
            if ref.exists():
                pinned = snaps / ref.read_text().strip()
                if pinned.is_dir() and _looks_like_snapshot(pinned):
                    return pinned
            # Otherwise prefer revisions that actually carry weights (an
            # aborted download can leave a newer config-only revision).
            revs = [d for d in sorted(snaps.iterdir()) if d.is_dir()]
            with_weights = [d for d in revs if any((d / f).exists() for f in _WEIGHT_FILES)]
            candidates = with_weights or [d for d in revs if _looks_like_snapshot(d)]
            if candidates:
                return max(candidates, key=lambda d: d.stat().st_mtime)
    raise FileNotFoundError(
        f"No local snapshot for {repo!r}. Searched: {searched}. Place an HF "
        f"snapshot (config.json + model.safetensors) in one of these, or set "
        f"${SNAPSHOT_ROOT_ENV} to a directory laid out as <root>/<org>/<name>."
    )


def read_hf_config(snapshot_dir: str | Path) -> dict[str, Any] | None:
    """Load ``config.json`` from a snapshot directory, or None if absent."""
    path = Path(snapshot_dir) / "config.json"
    if not path.exists():
        return None
    with open(path) as f:
        return json.load(f)


def _pick(d: Mapping[str, Any], *names: str) -> Any:
    for n in names:
        if n in d and d[n] is not None:
            return d[n]
    return None


def _apply_aliases(cfg_cls: type, defaults: Any, alias_map: dict[str, tuple[str, ...]], *sources: Mapping[str, Any]) -> Any:
    """Build kwargs for ``cfg_cls`` from the first source that defines each field."""
    kwargs: dict[str, Any] = {}
    for field, names in alias_map.items():
        for src in sources:
            val = _pick(src, *names)
            if val is not None:
                kwargs[field] = val
                break
    return dataclasses.replace(defaults, **kwargs)


def timesfm_config_from_hf(hf: Mapping[str, Any], defaults: Any = None) -> Any:
    """Map an HF ``config.json`` dict onto :class:`TimesFMConfig`.

    Upstream TimesFM 2.5 hard-codes the 200M geometry in code; if its
    snapshot ships a config.json, these aliases pick up whichever naming it
    uses.
    """
    from multimodal_timesfm_torch.models.timesfm import TimesFMConfig

    aliases = {
        "input_patch_len": ("input_patch_len", "patch_len", "patch_length", "input_patch_size"),
        "output_patch_len": ("output_patch_len", "output_patch_size", "horizon_length"),
        "model_dims": ("model_dims", "hidden_size", "d_model", "model_dim"),
        "ffn_dims": ("ffn_dims", "intermediate_size", "d_ff", "ffn_dim"),
        "num_layers": ("num_layers", "num_hidden_layers", "num_blocks"),
        "num_heads": ("num_heads", "num_attention_heads"),
        # NOTE: deliberately no "num_quantiles" alias here — TimesFM's channel
        # count is point + quantiles, handled by the quantiles-list branch
        # below; mapping num_quantiles directly would be off by one.
        "num_output_channels": ("num_output_channels",),
        "decode_index": ("decode_index",),
        "quantile_horizon": ("quantile_horizon", "max_horizon"),
    }
    cfg = _apply_aliases(TimesFMConfig, defaults or TimesFMConfig(), aliases, hf)
    quantiles = _pick(hf, "quantiles")
    if quantiles is not None:
        cfg = dataclasses.replace(cfg, quantiles=tuple(quantiles))
        # None-aware like _pick everywhere else: an explicit null must not
        # block the quantiles-derived channel count.
        if _pick(hf, "num_output_channels") is None:
            cfg = dataclasses.replace(cfg, num_output_channels=1 + len(quantiles))
    return cfg


def chronos2_config_from_hf(hf: Mapping[str, Any], defaults: Any = None) -> Any:
    """Map an HF ``config.json`` dict onto :class:`Chronos2Config`.

    Handles both top-level fields and the nested ``chronos_config`` dict the
    upstream config class exposes, plus T5-style base-model names
    (``d_model``/``num_heads``/``d_ff``).
    """
    from multimodal_timesfm_torch.models.chronos import Chronos2Config

    nested = hf.get("chronos_config") or hf.get("chronos2_config") or {}
    aliases = {
        "model_dim": ("model_dim", "d_model", "hidden_size"),
        "num_layers": ("num_layers", "num_hidden_layers"),
        "num_heads": ("num_heads", "num_attention_heads"),
        "ffn_dim": ("ffn_dim", "d_ff", "intermediate_size"),
        "input_patch_size": ("input_patch_size",),
        "output_patch_size": ("output_patch_size",),
        "max_output_patches": ("max_output_patches",),
        "time_encoding_scale": ("time_encoding_scale",),
        "use_reg_token": ("use_reg_token",),
        "reg_token_id": ("reg_token_id",),
        "vocab_size": ("vocab_size",),
        "rel_pos_buckets": ("rel_pos_buckets", "relative_attention_num_buckets"),
        "rel_pos_max_distance": ("rel_pos_max_distance", "relative_attention_max_distance"),
    }
    cfg = _apply_aliases(Chronos2Config, defaults or Chronos2Config(), aliases, nested, hf)
    quantiles = _pick(nested, "quantiles") or _pick(hf, "quantiles")
    if quantiles is not None:
        cfg = dataclasses.replace(cfg, quantiles=tuple(quantiles))
    return cfg


def bert_config_from_hf(hf: Mapping[str, Any], defaults: Any = None) -> Any:
    """Map an HF BERT ``config.json`` onto :class:`text.bert.BertConfig`."""
    from multimodal_timesfm_torch.text.bert import BertConfig

    aliases = {
        "vocab_size": ("vocab_size",),
        "hidden_size": ("hidden_size",),
        "num_layers": ("num_hidden_layers", "num_layers"),
        "num_heads": ("num_attention_heads", "num_heads"),
        "intermediate_size": ("intermediate_size",),
        "max_position_embeddings": ("max_position_embeddings",),
        "type_vocab_size": ("type_vocab_size",),
        "layer_norm_eps": ("layer_norm_eps",),
    }
    return _apply_aliases(BertConfig, defaults or BertConfig(), aliases, hf)


def modernbert_config_from_hf(hf: Mapping[str, Any], defaults: Any = None) -> Any:
    """Map an HF ModernBERT ``config.json`` onto :class:`ModernBertConfig`."""
    from multimodal_timesfm_torch.text.modernbert import ModernBertConfig

    aliases = {
        "vocab_size": ("vocab_size",),
        "hidden_size": ("hidden_size",),
        "num_layers": ("num_hidden_layers", "num_layers"),
        "num_heads": ("num_attention_heads", "num_heads"),
        "intermediate_size": ("intermediate_size",),
        "global_attn_every_n_layers": ("global_attn_every_n_layers",),
        "local_attention_window": ("local_attention", "local_attention_window"),
        "global_rope_theta": ("global_rope_theta",),
        "local_rope_theta": ("local_rope_theta",),
        "layer_norm_eps": ("norm_eps", "layer_norm_eps"),
    }
    return _apply_aliases(ModernBertConfig, defaults or ModernBertConfig(), aliases, hf)
