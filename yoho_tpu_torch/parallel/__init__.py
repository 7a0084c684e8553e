"""Multi-GPU serving and training on ``torch.distributed``: the (data,
model) mesh and its collectives, the differentiable ones and the gradient
buckets among them (``mesh``), the partition rules and the tensor-parallel
layout (``sharding``), ring attention (``ring_attention``), sequence-parallel
long encoding and its train step (``long_encoder``) and the pipelined
encoder and its GPipe train step (``pipeline``)."""

from yoho_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_MODEL,
    Mesh,
    init_distributed,
    init_mesh,
    data_shard,
    make_mesh,
    parse_mesh,
    reduce_gradients,
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
    make_long_context_loss_fn,
    make_long_context_train_step,
    yoho_encode_long,
)
from yoho_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pipeline_loss_fn,
    make_pipeline_train_step,
    pipeline_encode,
)
