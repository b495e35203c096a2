"""Layers of the PyTorch port (mirrors vit_tpu.layers)."""
