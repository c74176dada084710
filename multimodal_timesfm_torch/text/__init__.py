"""Text encoders: frozen sentence encoders for the offline embedding cache.

The English encoder is all-MiniLM-L6-v2's BERT (384-d), the Japanese one
ruri-v3-310m's ModernBERT (768-d), each with mean pooling and L2
normalisation, as PyTorch modules on the CUDA device; tokenizers run on the
host (WordPiece with a native C++ path, HF's for ruri, a hash fallback).
"""

from multimodal_timesfm_torch.text.encoders import (  # noqa: F401
    EnglishTextEncoder,
    JapaneseTextEncoder,
    TextEncoderBase,
    build_text_encoder,
)
