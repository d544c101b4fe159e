from real_time_self_adaptive_deep_stereo_torch.ops.conv import (  # noqa: F401
    PRECISIONS,
    conv2d,
    conv2d_transpose,
    conv_precision,
    dilated_conv2d,
    get_conv_precision,
    init_conv,
    leaky_relu,
    set_conv_precision,
)
from real_time_self_adaptive_deep_stereo_torch.ops.correlation import (  # noqa: F401
    correlation,
    correlation_bwd_cuda,
    correlation_cuda,
    correlation_torch,
    correlation_torch_bwd,
    resolve_corr_mode,
)
from real_time_self_adaptive_deep_stereo_torch.ops.resize import (  # noqa: F401
    crop_or_pad,
    pad_image,
    padded_shape,
    resize_bilinear,
    resize_to,
)
from real_time_self_adaptive_deep_stereo_torch.ops.warp import (  # noqa: F401
    bilinear_sampler,
    resolve_warp_mode,
    warp_features_clamped,
    warp_features_clamped_bwd,
    warp_features_horizontal,
    warp_features_onehot,
    warp_features_onehot_bwd,
    warp_image,
    warp_image_clamped,
    warp_image_clamped_bwd,
    warp_image_onehot,
    warp_image_onehot_bwd,
)
from real_time_self_adaptive_deep_stereo_torch.ops.warp_kernels import (  # noqa: F401
    warp_features_bwd_cuda,
    warp_features_by_mode,
    warp_features_cuda,
    warp_features_mxu,
    warp_features_mxu_bwd,
    warp_image_bwd_cuda,
    warp_image_by_mode,
    warp_image_cuda,
    warp_image_mxu,
    warp_image_mxu_bwd,
)
