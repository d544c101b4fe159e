"""Several processes over one ``torch.distributed`` group: the port of the
JAX package's ``parallel/`` (its data-parallel training; the width-sharded
adaptation step is not ported, ``ROADMAP.md``, queue 1, ``parallel/``)."""

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
)
