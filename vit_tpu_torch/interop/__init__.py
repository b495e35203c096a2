"""Interop of the PyTorch port (mirrors vit_tpu.interop)."""
