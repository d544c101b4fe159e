from real_time_self_adaptive_deep_stereo_torch.losses.factory import (  # noqa: F401
    ALL_LOSSES,
    PIXELWISE_LOSSES,
    SUPERVISED_LOSS,
    get_proxy_loss,
    get_reprojection_loss,
    get_supervised_loss,
)
