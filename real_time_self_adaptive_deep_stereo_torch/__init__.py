"""PyTorch/CUDA port of the real-time self-adaptive deep stereo framework.

A second package beside ``real_time_self_adaptive_deep_stereo_tpu``
(the JAX reference, which stays as it is). It imports ``torch`` and never
``jax`` or the JAX package. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; the kernels of the JAX package's Pallas
path are hand-written CUDA kernels under ``csrc/``, built at first use.
"""

__version__ = "0.1.0"

from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net  # noqa: F401,E402
