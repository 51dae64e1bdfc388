"""apex_tpu_torch — the PyTorch + CUDA port of ``apex_tpu`` for one NVIDIA
H100 (Hopper, sm_90a).

The package mirrors ``apex_tpu``'s tree file for file and keeps its
layouts and parameter keys (BSND activations, layers stacked on a
leading ``L`` axis, the paged pool ``[L, num_blocks, block_size,
kv_groups, dh]``), so a JAX parameter tree crosses over through numpy
with no renaming (``models/convert.py``).  It imports neither ``jax``
nor ``apex_tpu``.

Every TPU kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use (``ops/_kernel_utils.py``).
Each kernel-backed op launches its kernel for CUDA tensors and runs its
plain PyTorch version for CPU tensors; entry points run on ``cuda``
unless the caller passes ``device="cpu"``.

Ported so far: the GPT serving path ``models.generate.generate``
(prefill → paged decode → sampling) and the single-device AMP train step
``models.gpt.make_gpt_train_step`` (``amp``, ``optimizers.fused_adam``,
the LayerNorm and flash-attention backward kernels).
"""

__version__ = "0.1.0"

_LAZY_SUBMODULES = ("amp", "models", "ops", "optimizers", "serving", "utils")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib

        mod = importlib.import_module(f"apex_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'apex_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals().keys()) + list(_LAZY_SUBMODULES))
