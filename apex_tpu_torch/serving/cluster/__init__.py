"""apex_tpu_torch.serving.cluster (``apex_tpu/serving/cluster``): the
disaggregated serving tier.

- :mod:`~apex_tpu_torch.serving.cluster.protocol` — length-prefixed
  stdlib-socket frames (JSON control header + raw tensor blobs);
- :mod:`~apex_tpu_torch.serving.cluster.handoff` — the KV wire format
  (raw, bf16 or block-scaled int8), byte-compatible with the JAX
  package's;
- :mod:`~apex_tpu_torch.serving.cluster.worker` — prefill executors and
  decode engines behind the socket RPC surface, in-process or as their
  own OS processes (``python -m apex_tpu_torch.serving.cluster.worker``);
- :mod:`~apex_tpu_torch.serving.cluster.router` — the SLO-aware control
  plane: per-class admission caps, priority dispatch, adapter, prefix and
  headroom placement, requeue on worker death, drain and migration,
  ``cluster.*`` telemetry and autoscaling hints;
- :mod:`~apex_tpu_torch.serving.cluster.controller` — the elastic pool
  controller that acts on those hints.

The wire is the JAX package's: a port router drives JAX workers and a
JAX router drives port workers, and a handoff crosses packages.
"""

from apex_tpu_torch.serving.cluster.controller import (  # noqa: F401
    PoolController)
from apex_tpu_torch.serving.cluster.handoff import (  # noqa: F401
    WIRE_DTYPES, decode_kv, encode_kv, wire_bytes)
from apex_tpu_torch.serving.cluster.protocol import (  # noqa: F401
    ProtocolError, recv_msg, send_msg)
from apex_tpu_torch.serving.cluster.router import (  # noqa: F401
    DEFAULT_CLASS_PRIORITY, ClusterResponse, Router, RouterBusy)
from apex_tpu_torch.serving.cluster.worker import (  # noqa: F401
    WorkerServer, spawn_worker)

__all__ = ["DEFAULT_CLASS_PRIORITY", "ClusterResponse", "PoolController",
           "ProtocolError", "Router", "RouterBusy", "WIRE_DTYPES",
           "WorkerServer", "decode_kv", "encode_kv", "recv_msg",
           "send_msg", "spawn_worker", "wire_bytes"]
