"""Model modules: layers, the TimesFM 2.5 adapter, the fusion MLP and the decoder."""
