"""Models of the PyTorch port (mirrors vit_tpu.models)."""
