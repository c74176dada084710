"""HF BERT snapshot -> JAX-layout params tree for the sentence encoders.

Counterpart of the JAX package's ``text/convert.py``: reads a locally
downloaded HF model directory (e.g. ``sentence-transformers/all-MiniLM-L6-v2``)
into the ``text/bert.py`` tree, which ``models/bridge.load_jax_params`` loads
into a :class:`~multimodal_timesfm_torch.text.bert.BertEncoder`, plus its
``vocab.txt`` WordPiece tokenizer. Torch linear weights are (out, in) and
become (in, out) kernels. ``model.safetensors`` is read with the
port's own reader (``utils/safetensors.py``, no ``safetensors`` package);
``pytorch_model.bin`` with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from multimodal_timesfm_torch.text.bert import BertConfig
from multimodal_timesfm_torch.text.tokenizer import WordPieceTokenizer
from multimodal_timesfm_torch.utils import safetensors


def load_state_dict(model_dir: Path) -> dict[str, np.ndarray]:
    """Read model.safetensors or pytorch_model.bin into numpy arrays."""
    st_path = model_dir / "model.safetensors"
    if st_path.exists():
        sd = safetensors.load_file(st_path)
    else:
        bin_path = model_dir / "pytorch_model.bin"
        if not bin_path.exists():
            raise FileNotFoundError(f"No model.safetensors or pytorch_model.bin in {model_dir}")
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def convert_hf_bert_state(sd: dict[str, Any], cfg: BertConfig) -> dict[str, Any]:
    """Map HF BERT parameter names to the ``text/bert.py`` tree (numpy, fp32).

    Raises ``KeyError`` naming the first missing parameter; keys the tree does
    not use (the pooler, ``position_ids``) are ignored.
    """
    if any(k.startswith("bert.") for k in sd):
        sd = {k.removeprefix("bert."): v for k, v in sd.items()}

    def leaf(name: str) -> np.ndarray:
        if name not in sd:
            raise KeyError(f"{name} is missing from the BERT state dict")
        return np.asarray(sd[name], np.float32)

    def dense(prefix: str) -> dict[str, np.ndarray]:
        return {"kernel": np.ascontiguousarray(leaf(f"{prefix}.weight").T), "bias": leaf(f"{prefix}.bias")}

    def ln(prefix: str) -> dict[str, np.ndarray]:
        return {"scale": leaf(f"{prefix}.weight"), "bias": leaf(f"{prefix}.bias")}

    tree: dict[str, Any] = {
        "embeddings": {
            "word": leaf("embeddings.word_embeddings.weight"),
            "position": leaf("embeddings.position_embeddings.weight"),
            "token_type": leaf("embeddings.token_type_embeddings.weight"),
            "ln": ln("embeddings.LayerNorm"),
        },
        "layers": [],
    }
    for i in range(cfg.num_layers):
        base = f"encoder.layer.{i}"
        tree["layers"].append(
            {
                "q": dense(f"{base}.attention.self.query"),
                "k": dense(f"{base}.attention.self.key"),
                "v": dense(f"{base}.attention.self.value"),
                "attn_out": dense(f"{base}.attention.output.dense"),
                "attn_ln": ln(f"{base}.attention.output.LayerNorm"),
                "ffn_up": dense(f"{base}.intermediate.dense"),
                "ffn_down": dense(f"{base}.output.dense"),
                "ffn_ln": ln(f"{base}.output.LayerNorm"),
            }
        )
    return tree


def hf_bert_state(tree: dict[str, Any]) -> dict[str, np.ndarray]:
    """The inverse of :func:`convert_hf_bert_state`: a ``text/bert.py`` tree under HF's
    parameter names, (out, in) weights, as a snapshot's state dict holds it."""
    emb = tree["embeddings"]
    sd = {
        "embeddings.word_embeddings.weight": emb["word"],
        "embeddings.position_embeddings.weight": emb["position"],
        "embeddings.token_type_embeddings.weight": emb["token_type"],
        "embeddings.LayerNorm.weight": emb["ln"]["scale"],
        "embeddings.LayerNorm.bias": emb["ln"]["bias"],
    }
    names = {
        "q": "attention.self.query", "k": "attention.self.key", "v": "attention.self.value",
        "attn_out": "attention.output.dense", "ffn_up": "intermediate.dense",
        "ffn_down": "output.dense", "attn_ln": "attention.output.LayerNorm",
        "ffn_ln": "output.LayerNorm",
    }
    for i, layer in enumerate(tree["layers"]):
        for key, name in names.items():
            prefix = f"encoder.layer.{i}.{name}"
            leaf = layer[key]
            weight = leaf["scale"] if "scale" in leaf else leaf["kernel"].T
            sd[f"{prefix}.weight"] = np.ascontiguousarray(weight, np.float32)
            sd[f"{prefix}.bias"] = np.asarray(leaf["bias"], np.float32)
    return sd


def load_hf_bert(model_dir: Path, cfg: BertConfig) -> tuple[dict[str, Any], WordPieceTokenizer]:
    """Load (params tree, tokenizer) from a local HF snapshot directory."""
    tree = convert_hf_bert_state(load_state_dict(model_dir), cfg)
    vocab = model_dir / "vocab.txt"
    if not vocab.exists():
        raise FileNotFoundError(f"vocab.txt not found in {model_dir}")
    return tree, WordPieceTokenizer(vocab)
