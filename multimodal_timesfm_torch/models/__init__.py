"""Model modules: layers, the TimesFM 2.5 and Chronos-2 adapters, the fusion MLP and the decoder."""
