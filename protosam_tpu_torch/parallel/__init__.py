"""Multi-GPU inference on ``torch.distributed`` (JAX ``parallel``): the
(data, model) grid and the Megatron split (``sharding``), the two-stage
pipeline (``pipeline``)."""

from protosam_tpu_torch.parallel.sharding import (  # noqa: F401
    encoder_param_sharding,
    make_mesh,
    shard_batch,
)
from protosam_tpu_torch.parallel.pipeline import (  # noqa: F401
    PipelinedVolumeRunner,
)
