"""Mixed-precision policies: the O0–O5 opt levels as explicit dtypes
(``apex_tpu/amp/policy.py``).

====  ===========  =============  ==========  ==============  ===========
lvl   param dtype  compute dtype  norms fp32  master weights  loss scale
====  ===========  =============  ==========  ==============  ===========
O0    fp32         fp32           n/a         no              1.0
O1    fp32         fp16 (listed)  yes         no              dynamic
O2    fp16         fp16           yes         yes             dynamic
O3    fp16         fp16           no          no              1.0
O4    fp32         bf16 (listed)  yes         no              1.0
O5    bf16         bf16           yes         yes             1.0
====  ===========  =============  ==========  ==============  ===========

A policy is applied functionally at the train-step boundary: the fp32
masters are cast to the parameter dtype before the forward, whose
matmuls then cast each weight to the activations' dtype
(``cfg.compute_dtype``).  Under O2 that is the chain fp32 master → fp16
parameter → bf16 compute, the chain the JAX package runs off the TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch

__all__ = ["Policy", "O0", "O1", "O2", "O3", "O4", "O5", "opt_levels",
           "policy_for_opt_level"]


def _is_norm_param(path: tuple) -> bool:
    """Heuristic: does this param path belong to a normalization layer?

    The JAX package's keyword test over the tree path, copied as it is
    (it matches none of the GPT keys — ``ln1_scale``, ``final_ln`` … —
    so under O2 the norm scales are fp16 too, as in JAX)."""
    keywords = ("batchnorm", "batch_norm", "bn", "layernorm", "layer_norm",
                "groupnorm", "group_norm", "norm")
    for key in path:
        name = getattr(key, "key", getattr(key, "name", str(key)))
        low = str(name).lower()
        if any(k in low for k in keywords):
            return True
    return False


def _effective(dtype):
    """The JAX package maps fp16 to bf16 on a TPU only; there is no TPU
    here, so every dtype stays as it is."""
    return dtype


@dataclasses.dataclass(frozen=True)
class Policy:
    """Functional dtype policy: what dtype params, compute and outputs use."""

    opt_level: str = "O0"
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    output_dtype: Any = torch.float32
    keep_norm_fp32: bool = False
    master_weights: bool = False
    loss_scale: Union[str, float] = 1.0
    # O1/O4 express per-op casting rather than casting params
    per_op_casts: bool = False
    norm_predicate: Callable[[tuple], bool] = _is_norm_param

    def _cast_tree(self, tree, dtype, respect_norms: bool, path=()):
        dtype = _effective(dtype)
        if isinstance(tree, dict):
            return {k: self._cast_tree(v, dtype, respect_norms, path + (k,))
                    for k, v in tree.items()}
        if not (torch.is_tensor(tree) and tree.is_floating_point()):
            return tree
        if respect_norms and self.keep_norm_fp32 and self.norm_predicate(
                path):
            return tree.to(torch.float32)
        return tree.to(dtype)

    def cast_params(self, params):
        """Model-storage cast (reference ``model.to(cast_model_type)``)."""
        return self._cast_tree(params, self.param_dtype, respect_norms=True)

    def cast_to_compute(self, tree, respect_norms: bool = False):
        """Cast activations/inputs to the compute dtype."""
        return self._cast_tree(tree, self.compute_dtype, respect_norms)

    def cast_to_output(self, tree):
        return self._cast_tree(tree, self.output_dtype, respect_norms=False)

    def cast_master(self, params):
        """fp32 master copy for the optimizer."""
        return self._cast_tree(params, torch.float32, respect_norms=False)

    @property
    def uses_loss_scaling(self) -> bool:
        return self.loss_scale == "dynamic" or (
            isinstance(self.loss_scale, (int, float))
            and self.loss_scale != 1.0)


O0 = Policy("O0")
O1 = Policy("O1", compute_dtype=torch.float16, keep_norm_fp32=True,
            loss_scale="dynamic", per_op_casts=True)
O2 = Policy("O2", param_dtype=torch.float16, compute_dtype=torch.float16,
            keep_norm_fp32=True, master_weights=True, loss_scale="dynamic")
O3 = Policy("O3", param_dtype=torch.float16, compute_dtype=torch.float16)
O4 = Policy("O4", compute_dtype=torch.bfloat16, keep_norm_fp32=True,
            per_op_casts=True)
O5 = Policy("O5", param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
            keep_norm_fp32=True, master_weights=True)

opt_levels = {"O0": O0, "O1": O1, "O2": O2, "O3": O3, "O4": O4, "O5": O5}

# reference amp.initialize kwarg names → Policy field names
_REFERENCE_KEY_ALIASES = {
    "keep_batchnorm_fp32": "keep_norm_fp32",
    "cast_model_type": "param_dtype",
    "patch_torch_functions": "per_op_casts",
}


def policy_for_opt_level(opt_level: Union[str, Policy],
                         **overrides) -> Policy:
    """Look up an opt level and apply user overrides (reference kwarg
    names accepted as aliases)."""
    if isinstance(opt_level, Policy):
        policy = opt_level
    else:
        if opt_level not in opt_levels:
            raise ValueError(
                f"Unexpected optimization level {opt_level!r}; "
                "options are 'O0', 'O1', 'O2', 'O3', 'O4', 'O5'.")
        policy = opt_levels[opt_level]
    if overrides:
        overrides = {_REFERENCE_KEY_ALIASES.get(k, k): v
                     for k, v in overrides.items()}
        fields = {f.name for f in dataclasses.fields(Policy)}
        unknown = set(overrides) - fields
        if unknown:
            raise ValueError(
                f"Unknown amp option(s) {sorted(unknown)}; valid options: "
                f"{sorted(fields | set(_REFERENCE_KEY_ALIASES))}")
        policy = dataclasses.replace(policy, **overrides)
    return policy
