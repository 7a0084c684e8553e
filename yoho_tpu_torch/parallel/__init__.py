"""Multi-GPU serving on ``torch.distributed``: the (data, model) mesh and
its collectives (``mesh``), the partition rules and the tensor-parallel
layout (``sharding``), ring attention (``ring_attention``), sequence-parallel
long encoding (``long_encoder``) and the pipelined encoder (``pipeline``)."""

from yoho_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_MODEL,
    Mesh,
    init_distributed,
    init_mesh,
    make_mesh,
    parse_mesh,
    shard_batch,
)
from yoho_tpu_torch.parallel.sharding import (  # noqa: F401
    WHISPER_RULES,
    YOHO_RULES,
    P,
    PartitionRules,
    partition_specs,
    shard_params,
)
from yoho_tpu_torch.parallel.ring_attention import ring_attention  # noqa: F401
from yoho_tpu_torch.parallel.long_encoder import (  # noqa: F401
    make_long_context_train_step,
    yoho_encode_long,
)
from yoho_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pipeline_train_step,
    pipeline_encode,
)
