"""Fault-tolerant training state of the port (``apex_tpu/checkpoint``),
single process: the JAX package's sharded on-disk format
(:mod:`~apex_tpu_torch.checkpoint.sharded`, one shard file and an
atomically committed manifest with content digests; each package
restores the other's checkpoints), the overlapped saver
(:mod:`~apex_tpu_torch.checkpoint.async_saver`) and rollback on a
non-finite loss with a learning-rate re-warm
(:mod:`~apex_tpu_torch.checkpoint.recovery`)."""

from apex_tpu_torch.checkpoint.sharded import (  # noqa: F401
    MANIFEST_NAME,
    MANIFEST_SCHEMA_VERSION,
    CheckpointError,
    all_steps,
    latest_step,
    load_manifest,
    prune_checkpoints,
    restore_sharded,
    save_sharded,
)
from apex_tpu_torch.checkpoint.async_saver import (  # noqa: F401
    AsyncCheckpointer,
    CheckpointWriteError,
    SaveResult,
)
from apex_tpu_torch.checkpoint.recovery import (  # noqa: F401
    RecoveryGivingUp,
    RecoveryManager,
    RollbackConfig,
)

__all__ = ["MANIFEST_NAME", "MANIFEST_SCHEMA_VERSION", "CheckpointError",
           "AsyncCheckpointer", "CheckpointWriteError", "SaveResult",
           "RecoveryGivingUp", "RecoveryManager", "RollbackConfig",
           "all_steps", "latest_step", "load_manifest", "prune_checkpoints",
           "restore_sharded", "save_sharded"]
