"""Multi-tenant LoRA adapters: per-request low-rank deltas over a frozen
base model (``apex_tpu/models/lora.py``).

An adapter holds, per target matmul, ``A [L, in, r]`` and ``B [L, r,
out]`` with ``W' = W + (alpha / r) * A @ B``.  Two ways to apply it:

- :func:`merge_lora` folds the delta into the (float) base kernels: the
  per-tenant numerics reference;
- :func:`batched_lora_delta` keeps the base frozen (float or int8),
  stacks the resident adapters into ``[G, in, r]`` / ``[G, r, out]``
  slabs, sorts the batch rows by slot (:func:`lora_plan`) and runs two
  ragged grouped matmuls (kernel row 9) over the sorted rows.  Rows with
  no adapter (slot 0) sort before ``offsets[0]``, where the grouped
  matmul returns exact zeros.

The slot ids and the plan stay on the device: :func:`lora_plan` sorts
and counts there, with no host read, so a decode step keeps one shape
for every adapter mix.  Slabs are fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops.dense import is_quantized, quantized_matmul
from apex_tpu_torch.ops.grouped_matmul import grouped_matmul
from apex_tpu_torch.ops.swiglu import fused_bias_swiglu_paired

__all__ = ["LoRAAdapter", "TARGETS", "target_shapes", "init_lora_adapter",
           "adapter_bytes", "merge_lora", "stack_adapter_slabs",
           "lora_plan", "batched_lora_delta", "lora_mlp"]

TARGETS = ("qkv", "proj", "fc1", "fc2")
_KERNEL_OF = {"qkv": "qkv_kernel", "proj": "proj_kernel",
              "fc1": "fc1_kernel", "fc2": "fc2_kernel"}


@dataclasses.dataclass(frozen=True)
class LoRAAdapter:
    """One adapter: per-target ``A [L, in, r]`` / ``B [L, r, out]`` factor
    stacks (layer axis leading, like the base layer stack) and the rank
    and alpha.  ``out`` is flattened for multi-axis kernels."""

    rank: int
    alpha: float
    a: Dict[str, torch.Tensor]
    b: Dict[str, torch.Tensor]

    @property
    def targets(self) -> Tuple[str, ...]:
        return tuple(t for t in TARGETS if t in self.a)

    @property
    def scaling(self) -> float:
        return float(self.alpha) / float(self.rank)


def target_shapes(cfg) -> Dict[str, Tuple[int, int]]:
    """``target -> (in_dim, out_dim_flat)`` for one layer of ``cfg``."""
    h = cfg.hidden_size
    p = cfg.projection_size
    kv = cfg.kv_projection_size
    f = cfg.ffn_hidden_size
    fc1_out = 2 * f if cfg.activation == "swiglu" else f
    return {"qkv": (h, p + 2 * kv), "proj": (p, h),
            "fc1": (h, fc1_out), "fc2": (f, h)}


def init_lora_adapter(generator: torch.Generator, cfg, *, rank: int = 8,
                      alpha: Optional[float] = None,
                      targets: Sequence[str] = TARGETS,
                      b_std: float = 0.0, dtype=torch.float32,
                      device=None) -> LoRAAdapter:
    """Fresh adapter for ``cfg``: ``A ~ N(0, 1/r)``, ``B ~ N(0, b_std²)``
    (zero at the default, the identity-at-init), drawn from
    ``generator`` target by target, A then B.  ``alpha`` defaults to
    ``rank`` (scaling 1); tensors land on ``device`` (default: the
    generator's)."""
    if rank < 1:
        raise ValueError(f"rank={rank}: need a positive LoRA rank")
    targets = tuple(targets)
    unknown = [t for t in targets if t not in TARGETS]
    if unknown:
        raise ValueError(f"unknown LoRA targets {unknown}; expected a "
                         f"subset of {TARGETS}")
    shapes = target_shapes(cfg)
    L = cfg.num_layers
    gdev = generator.device
    dev = gdev if device is None else torch.device(device)
    a, b = {}, {}
    for t in targets:
        d_in, d_out = shapes[t]
        at = torch.randn(L, d_in, rank, generator=generator,
                         device=gdev) / rank ** 0.5
        bt = torch.randn(L, rank, d_out, generator=generator,
                         device=gdev) * b_std
        a[t] = at.to(device=dev, dtype=dtype)
        b[t] = bt.to(device=dev, dtype=dtype)
    return LoRAAdapter(rank=int(rank),
                       alpha=float(rank if alpha is None else alpha),
                       a=a, b=b)


def adapter_bytes(adapter: LoRAAdapter) -> int:
    """Device bytes of one adapter (both factors, all targets and
    layers): the unit the pool's byte bound divides by."""
    return int(sum(t.numel() * t.element_size()
                   for d in (adapter.a, adapter.b) for t in d.values()))


def merge_lora(params: dict, cfg, adapter: LoRAAdapter) -> dict:
    """A new params tree with each target kernel replaced by ``W +
    scaling * A @ B`` in fp32, cast back to the kernel's dtype.  A
    quantized base raises: an int8 slab cannot absorb a float delta."""
    layers = dict(params["layers"])
    for t in adapter.targets:
        kname = _KERNEL_OF[t]
        w = layers[kname]
        if is_quantized(w):
            raise ValueError(
                f"merge_lora: base kernel {kname!r} is int8-quantized; "
                "merging needs a float base — serve the adapter through "
                "the batched path instead")
        delta = torch.einsum("lir,lro->lio", adapter.a[t].float(),
                             adapter.b[t].float())
        delta = (adapter.scaling * delta).reshape(w.shape)
        layers[kname] = (w.float() + delta.to(w.device)).to(w.dtype)
    return dict(params, layers=layers)


def stack_adapter_slabs(adapters: Sequence[Optional[LoRAAdapter]],
                        cfg) -> Dict[str, Dict[str, torch.Tensor]]:
    """Stack ``G`` adapters into the grouped-matmul slab form ``target ->
    {"a": [L, G, in, r], "b": [L, G, r, out]}`` (fp32) with the scaling
    folded into ``b``; ``None`` entries are zero factors.  The live
    adapters must agree on rank and targets."""
    live = [a for a in adapters if a is not None]
    if not live:
        raise ValueError("stack_adapter_slabs: no adapters")
    rank = live[0].rank
    targets = live[0].targets
    for a in live[1:]:
        if a.rank != rank or a.targets != targets:
            raise ValueError(
                f"heterogeneous adapters: rank/targets "
                f"({a.rank}, {a.targets}) vs ({rank}, {targets})")
    shapes = target_shapes(cfg)
    L = cfg.num_layers
    dev = live[0].a[targets[0]].device
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for t in targets:
        d_in, d_out = shapes[t]
        a_stack, b_stack = [], []
        for ad in adapters:
            if ad is None:
                a_stack.append(torch.zeros(L, d_in, rank, device=dev))
                b_stack.append(torch.zeros(L, rank, d_out, device=dev))
            else:
                a_stack.append(ad.a[t].float())
                b_stack.append(ad.b[t].float() * ad.scaling)
        out[t] = {"a": torch.stack(a_stack, dim=1),
                  "b": torch.stack(b_stack, dim=1)}
    return out


def lora_plan(idx: torch.Tensor, n_slots: int) -> Dict[str, torch.Tensor]:
    """Sort plan for one batch: ``idx`` ``[N]`` per-row slot ids (0 = no
    adapter, ``s`` in ``[1, n_slots]`` = slab ``s - 1``) → ``{"order":
    [N], "offsets": [n_slots + 1] int32}``: the stable sort-by-slot
    permutation and the grouped-matmul bounds, slot-0 rows before
    ``offsets[0]``.  ``offsets[s]`` counts the rows with a slot ``<= s``
    (the JAX package's ``cumsum(bincount)``) by a search in the sorted
    ids: ``torch.bincount`` reads the largest id on the host, and this
    plan stays on the device."""
    idx = idx.to(torch.int32)
    ids, order = torch.sort(idx, stable=True)
    slots = torch.arange(n_slots + 1, dtype=torch.int32, device=idx.device)
    offsets = torch.searchsorted(ids, slots, right=True).to(torch.int32)
    return {"order": order, "offsets": offsets}


def batched_lora_delta(x, a_slab, b_slab, plan, *,
                       backend: Optional[str] = None):
    """Heterogeneous-adapter delta for one target matmul: ``x`` ``[...,
    in]`` (leading dims flattened to the plan's rows) → ``scaling * x @
    A[slot] @ B[slot]`` per row, ``[..., out]`` in ``x``'s dtype, zero for
    slot-0 rows.  Two grouped matmuls over the sorted rows in the slab
    dtype, then the inverse permutation by index assignment."""
    shape = tuple(x.shape)
    xs = x.reshape(-1, shape[-1])[plan["order"]].to(a_slab.dtype)
    mid = grouped_matmul(xs, a_slab, plan["offsets"], backend=backend)
    out = grouped_matmul(mid.to(b_slab.dtype), b_slab, plan["offsets"],
                         backend=backend)
    delta = torch.empty_like(out)
    delta[plan["order"]] = out
    return delta.reshape(shape[:-1] + (b_slab.shape[-1],)).to(x.dtype)


def lora_mlp(cfg, lp: dict, x, ll: dict, plan: dict, *,
             backend: Optional[str] = None):
    """The single-device MLP with the fc1/fc2 LoRA deltas at its two
    matmul seams; the fc1 delta lands before the bias and activation."""
    w1 = lp["fc1_kernel"]
    d1 = (batched_lora_delta(x, ll["fc1"]["a"], ll["fc1"]["b"], plan,
                             backend=backend) if "fc1" in ll else None)
    if cfg.activation == "swiglu":
        # the paired [h, 2, f] fc1; the adapter's B factor is [r, 2f]
        y = (quantized_matmul(x, w1, backend=backend) if is_quantized(w1)
             else torch.einsum("bsh,hcf->bscf", x, w1.to(x.dtype)))
        if d1 is not None:
            y = y + d1.reshape(y.shape)
        y = fused_bias_swiglu_paired(y, lp["fc1_bias"].to(x.dtype))
    else:
        y = quantized_matmul(x, w1, backend=backend)
        if d1 is not None:
            y = y + d1.reshape(y.shape)
        y = y + lp["fc1_bias"].to(x.dtype)
        y = F.gelu(y, approximate="tanh" if cfg.activation == "gelu_tanh"
                   else "none")
    out = quantized_matmul(y, lp["fc2_kernel"], backend=backend)
    if "fc2" in ll:
        out = out + batched_lora_delta(y, ll["fc2"]["a"], ll["fc2"]["b"],
                                       plan, backend=backend)
    return out + lp["fc2_bias"].to(x.dtype)
