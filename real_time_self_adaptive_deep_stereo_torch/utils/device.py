"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Without a GPU they raise instead of falling back. Every call also sets
PyTorch's TF32 flags from the convolution precision in force
(``ops/conv.py``): TF32 on cuDNN under ``default`` only, as JAX's
``Precision.DEFAULT`` on a GPU; off under ``highest``, the JAX package's
default, and under the bf16 modes; off for cuBLAS matmuls always. They are
set explicitly because PyTorch lets cuDNN use TF32 by default.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from real_time_self_adaptive_deep_stereo_torch.ops.conv import apply_precision_flags

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    apply_precision_flags()
    return dev
