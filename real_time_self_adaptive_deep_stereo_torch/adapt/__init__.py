from real_time_self_adaptive_deep_stereo_torch.adapt.blocks import (  # noqa: F401
    Block,
    default_block_config_path,
    load_block_config,
    make_blocks,
)
from real_time_self_adaptive_deep_stereo_torch.adapt.engine import (  # noqa: F401
    AdaptationEngine,
    d1_metric,
    disparity_metrics,
)
from real_time_self_adaptive_deep_stereo_torch.adapt.arena import (  # noqa: F401
    Arena,
    ArenaSpec,
    build_arena,
)
from real_time_self_adaptive_deep_stereo_torch.adapt.fused import (  # noqa: F401
    FusedOnlineSession,
)
from real_time_self_adaptive_deep_stereo_torch.adapt.runner import (  # noqa: F401
    OnlineAdaptationSession,
    SessionStats,
)
from real_time_self_adaptive_deep_stereo_torch.adapt.samplers import (  # noqa: F401
    AVAILABLE_SAMPLER,
    get_sampler,
    softmax,
)
