"""Several processes over one ``torch.distributed`` group: the port of the
JAX package's ``parallel/``: data-parallel training
(:func:`make_dp_train_step`) and the width-sharded adaptation step
(:func:`make_spatial_adapt_step`, :mod:`.spatial`)."""

from real_time_self_adaptive_deep_stereo_torch.parallel.sharding import (  # noqa: F401
    NamedSharding,
    batch_sharded,
    local_slice,
    make_mesh,
    replicated,
    shard_batch,
    width_sharded,
)
from real_time_self_adaptive_deep_stereo_torch.parallel.train import (  # noqa: F401
    make_dp_train_step,
    make_spatial_adapt_step,
)
