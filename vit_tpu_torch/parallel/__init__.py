"""Training steps (port of ``vit_tpu/parallel``; one device so far)."""
