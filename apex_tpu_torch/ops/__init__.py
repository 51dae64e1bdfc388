"""Kernel-backed ops of the port (see each module).

``flat_adam_update`` is exported here as in the JAX package, resolved at
first use: ``ops.flat_adam`` imports the multi-tensor layer, which
imports ``ops._kernel_utils``."""

__all__ = ["flat_adam_update"]


def __getattr__(name):
    if name == "flat_adam_update":
        from apex_tpu_torch.ops.flat_adam import flat_adam_update

        return flat_adam_update
    raise AttributeError(f"module 'apex_tpu_torch.ops' has no attribute {name!r}")
