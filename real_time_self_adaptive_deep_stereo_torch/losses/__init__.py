from real_time_self_adaptive_deep_stereo_torch.losses.factory import (  # noqa: F401
    ALL_LOSSES,
    get_reprojection_loss,
)
