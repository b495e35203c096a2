"""Input pipeline, debug, metrics and profiling utilities (mirrors
``vit_tpu.utils``): :mod:`~vit_tpu_torch.utils.data`,
:mod:`~vit_tpu_torch.utils.debug`, :mod:`~vit_tpu_torch.utils.metrics`,
:mod:`~vit_tpu_torch.utils.profiling`."""
