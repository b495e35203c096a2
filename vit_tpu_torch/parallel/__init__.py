"""Process group, device mesh and train steps (port of ``vit_tpu/parallel``;
data parallelism, tensor parallelism not yet)."""
