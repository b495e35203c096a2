"""Process group, device mesh, the tensor-parallel rule table and train
steps (port of ``vit_tpu/parallel``): data parallelism over the mesh's
``data`` axis, tensor parallelism over its ``model`` axis."""
