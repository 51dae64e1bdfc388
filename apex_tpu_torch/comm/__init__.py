"""apex_tpu_torch.comm (``apex_tpu/comm``): compressed and bucketed
gradient collectives, wired into the gradient-moving entry points by
``grad_comm=`` (``amp.make_train_step(axis_name=, grad_comm=)`` and
``parallel.distributed``).

- :mod:`~apex_tpu_torch.comm.quantize` — block-scaled int8 / bf16 wire
  formats (also the KV handoff's codec, ``serving/cluster/handoff.py``);
- :mod:`~apex_tpu_torch.comm.bucketing` — greedy dtype-segregated
  buckets with giant-leaf chunking;
- :mod:`~apex_tpu_torch.comm.reduce` — reduce-scatter → dequant-sum →
  requant → all-gather over a process group, the error-feedback state,
  and the ``collectives.compressed.{calls,bytes,raw_bytes}`` counters.

Wire bytes per gradient element (block 256): fp32 moves 8 per all-reduce
(both passes), bf16 4, int8 ~2.03.
"""

from apex_tpu_torch.comm.config import GradCommConfig, resolve  # noqa: F401
from apex_tpu_torch.comm.bucketing import (  # noqa: F401
    Bucket,
    BucketSlice,
    gather_bucket,
    plan_buckets,
    scatter_buckets,
)
from apex_tpu_torch.comm.quantize import (  # noqa: F401
    WIRE_DTYPES,
    dequantize_blocks,
    quantize_blocks,
)
from apex_tpu_torch.comm.reduce import (  # noqa: F401
    compressed_allreduce,
    compressed_reduce_scatter,
    init_error_state,
    reduce_gradients,
)

__all__ = [
    "GradCommConfig",
    "resolve",
    "WIRE_DTYPES",
    "quantize_blocks",
    "dequantize_blocks",
    "Bucket",
    "BucketSlice",
    "plan_buckets",
    "gather_bucket",
    "scatter_buckets",
    "compressed_allreduce",
    "compressed_reduce_scatter",
    "reduce_gradients",
    "init_error_state",
]
