from real_time_self_adaptive_deep_stereo_torch.ops.conv import (  # noqa: F401
    conv2d,
    dilated_conv2d,
    init_conv,
    leaky_relu,
)
from real_time_self_adaptive_deep_stereo_torch.ops.correlation import (  # noqa: F401
    correlation,
    correlation_bwd_cuda,
    correlation_cuda,
    correlation_torch,
    correlation_torch_bwd,
)
from real_time_self_adaptive_deep_stereo_torch.ops.resize import (  # noqa: F401
    crop_or_pad,
    pad_image,
    padded_shape,
    resize_bilinear,
    resize_to,
)
from real_time_self_adaptive_deep_stereo_torch.ops.warp import (  # noqa: F401
    resolve_warp_mode,
    warp_features_clamped,
    warp_features_clamped_bwd,
    warp_features_horizontal,
    warp_image,
    warp_image_clamped,
    warp_image_clamped_bwd,
)
from real_time_self_adaptive_deep_stereo_torch.ops.warp_kernels import (  # noqa: F401
    warp_features_bwd_cuda,
    warp_features_by_mode,
    warp_features_cuda,
    warp_image_bwd_cuda,
    warp_image_by_mode,
    warp_image_cuda,
)
