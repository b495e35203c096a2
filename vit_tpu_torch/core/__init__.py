"""Core of the PyTorch port (mirrors vit_tpu.core)."""
