"""apex_tpu_torch.parallel (``apex_tpu/parallel``): process bootstrap, the
rank mesh, data parallelism, gradient clipping over a group, and the
context-parallel attentions (ring and Ulysses).

Not in this slice: FSDP, SyncBatchNorm and LARC (later slices; see
ROADMAP.md).
"""

from apex_tpu_torch.parallel.clip_grad import (  # noqa: F401
    clip_grad_norm,
    clip_grad_norm_,
)
from apex_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedDataParallel,
    Reducer,
    allreduce_gradients,
    make_ddp_train_step,
)
from apex_tpu_torch.parallel.launch import (  # noqa: F401
    destroy_distributed,
    distributed_env,
    init_distributed,
)
from apex_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    create_mesh,
    data_parallel_mesh,
    replicate,
    shard_batch,
)
from apex_tpu_torch.parallel.ring_attention import ring_attention  # noqa: F401
from apex_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401
