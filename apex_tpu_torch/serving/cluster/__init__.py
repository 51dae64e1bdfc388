"""apex_tpu_torch.serving.cluster (``apex_tpu/serving/cluster``): the KV
handoff codec (:mod:`~apex_tpu_torch.serving.cluster.handoff`), which the
host-DRAM tier parks pages through.  The protocol, workers, router and
controller of the disaggregated tier are not ported yet."""

from apex_tpu_torch.serving.cluster.handoff import (  # noqa: F401
    WIRE_DTYPES, decode_kv, encode_kv, wire_bytes)

__all__ = ["WIRE_DTYPES", "decode_kv", "encode_kv", "wire_bytes"]
