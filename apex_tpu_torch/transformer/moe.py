"""Mixture-of-Experts MLP with capacity-limited and capacity-free routing
(``apex_tpu/transformer/moe.py``), single device.

- ``routing="capacity"``: the Switch formulation.  Top-k routing with a
  static per-expert capacity ``ceil(top_k · s · capacity_factor / E)``
  per batch row, dispatch and combine as one-hot einsums; tokens over
  capacity drop (``dropped_fraction``) and every expert pads to ``cap``
  slots.  No kernel of its own: the einsums are torch products.
- ``routing="ragged"``: capacity-free.  Token slots are sorted by expert
  (a stable argsort; the segment offsets from ``searchsorted`` over the
  sorted expert ids, so no host read), the expert FFNs run over ragged
  segments through :func:`~apex_tpu_torch.ops.grouped_matmul.
  grouped_matmul` (kernel row 9 on the card; its int8 branch for
  quantized slabs), and the gates combine through the inverse
  permutation, each token's k slots summed in slot order: deterministic,
  no atomic scatter.  No token is dropped.

The expert-parallel island of the JAX package (the ``shard_map`` over an
``ep`` mesh axis, the compressed all-to-all and the rings) belongs to
the distributed-training slice: ``ep_mesh=``, or ``overlap_comm=True``
with an ``ep`` axis, raise.  With ``ep_axis`` set and no mesh the local
math runs, as the JAX package does on one device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch.observability import metrics as _telemetry
from apex_tpu_torch.ops.dense import is_quantized
from apex_tpu_torch.ops.grouped_matmul import (
    group_ids, grouped_matmul, grouped_matmul_quantized)
from apex_tpu_torch.ops.swiglu import fused_bias_swiglu, mlp_gelu
from apex_tpu_torch.utils.registry import resolve_device

__all__ = ["init_moe_params", "switch_moe_mlp", "MoEOutput",
           "MOE_ROUTINGS"]

MOE_ROUTINGS = ("capacity", "ragged")
# the expert-parallel wire dtypes (apex_tpu/comm/quantize.py WIRE_DTYPES)
WIRE_DTYPES = ("fp32", "bf16", "int8")


class MoEOutput(NamedTuple):
    out: torch.Tensor                 # [b, s, h]
    aux_loss: torch.Tensor            # scalar load-balance loss (fp32)
    dropped_fraction: torch.Tensor    # scalar: token slots over capacity
    # per-expert router assignment counts [E] (all top-k selections,
    # before any drop), fp32
    expert_load: Optional[torch.Tensor] = None


def init_moe_params(generator: torch.Generator, hidden_size: int,
                    ffn_hidden_size: int, num_experts: int, *,
                    init_std: float = 0.02, dtype=torch.float32,
                    activation: str = "gelu", device=None) -> dict:
    """Expert-stacked FFN parameters ``[E, ...]`` and the router ``[h, E]``:
    N(0, init_std) weights drawn on the CPU from ``generator`` (router,
    fc1, fc2 in that order), zero biases, on ``device`` (default
    ``cuda``).  With ``activation='swiglu'`` fc1 carries the
    concatenated [gate ‖ up] columns (trailing dim 2f)."""
    dev = resolve_device(device)
    f1 = 2 * ffn_hidden_size if activation == "swiglu" else ffn_hidden_size

    def nrm(shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * init_std).to(device=dev, dtype=dtype)

    return {
        "router": nrm((hidden_size, num_experts)),
        "fc1": nrm((num_experts, hidden_size, f1)),
        "fc1_bias": torch.zeros(num_experts, f1, dtype=dtype, device=dev),
        "fc2": nrm((num_experts, ffn_hidden_size, hidden_size)),
        "fc2_bias": torch.zeros(num_experts, hidden_size, dtype=dtype,
                                device=dev),
    }


# ---------------------------------------------------------------------------
# shared routing and aux-loss pieces
# ---------------------------------------------------------------------------


def _router_probs(router, x2, noise_generator=None):
    """fp32 router logits and softmax; with ``noise_generator``, uniform
    noise in [-1e-2, 1e-2) drawn from it is added to the logits (JAX's
    threefry draw cannot be reproduced, so the generator is the
    caller's)."""
    logits = x2.float() @ router.float()
    if noise_generator is not None:
        noise = torch.rand(logits.shape, generator=noise_generator,
                           device=noise_generator.device)
        logits = logits + (noise.to(logits.device) * 2e-2 - 1e-2)
    return torch.softmax(logits, dim=-1)


def _topk_routing(probs, top_k: int):
    """Iterative-argmax top-k (the Switch selection rule; ties go to the
    first index): ``(choice [..., k] int64, gates [..., k] fp32)``."""
    e_n = probs.shape[-1]
    remaining = probs
    choices, gates = [], []
    for _ in range(top_k):
        c = torch.argmax(remaining, dim=-1)
        gates.append(torch.gather(remaining, -1, c[..., None])[..., 0])
        choices.append(c)
        remaining = remaining * (1.0 - F.one_hot(c, e_n).to(remaining.dtype))
    return torch.stack(choices, dim=-1), torch.stack(gates, dim=-1)


def _aux_loss(probs_mean, sel_counts, n_assignments):
    """Switch eq. 4 generalised to top-k: ``E · Σ_e f_e · P_e`` with
    ``f_e`` counting all k selections over the assignment count."""
    e_n = probs_mean.shape[-1]
    token_frac = sel_counts.float() / n_assignments
    return e_n * torch.sum(token_frac * probs_mean)


def _note_dropped(value: float) -> None:
    _telemetry.gauge("moe.dropped_fraction").set(float(value))


# ---------------------------------------------------------------------------
# grouped expert FFN over a sorted ragged layout
# ---------------------------------------------------------------------------


class _Permute(torch.autograd.Function):
    """``x[perm]`` for a permutation ``perm`` with inverse ``inv``: the
    gradient is the gather ``g[inv]``, not an accumulating scatter."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return g[inv], None, None


class _GroupRows(torch.autograd.Function):
    """Row ``r`` of ``table`` ``[G, ...]`` for each group id ``gid[r]`` in
    ``[0, G]``, id ``G`` a zero row (the rows outside the window).  The
    gradient of the table is each group's rows summed: one one-hot
    product with fp32 sums, where the gather's own backward would
    accumulate N rows into G + 1 through a scatter of repeated indices
    (slow, and in an order the card does not fix)."""

    @staticmethod
    def forward(ctx, table, gid):
        ctx.save_for_backward(gid)
        ctx.groups = table.shape[0]
        pad = table.new_zeros((1,) + tuple(table.shape[1:]))
        return torch.cat([table, pad])[gid]

    @staticmethod
    def backward(ctx, g):
        gid, = ctx.saved_tensors
        g2 = g.reshape(g.shape[0], -1)
        onehot = F.one_hot(gid, ctx.groups + 1)[:, :ctx.groups].t()
        if g.is_cuda and g.dtype in (torch.bfloat16, torch.float16):
            d = torch.mm(onehot.to(g.dtype), g2, out_dtype=torch.float32)
        else:
            d = onehot.to(torch.float32) @ g2.float()
        return d.reshape((ctx.groups,) + tuple(g.shape[1:])).to(g.dtype), None


def _expert_matmul(xs, w, offsets, dtype, backend):
    """One expert-slab matmul: a float slab cast to ``dtype`` through
    :func:`grouped_matmul`; a quantized slab (``{"wire", "scale"}``)
    through :func:`grouped_matmul_quantized` (row 9's int8 branch)."""
    if is_quantized(w):
        return grouped_matmul_quantized(xs.to(dtype), w["wire"], w["scale"],
                                        offsets, backend=backend)
    return grouped_matmul(xs.to(dtype), w.to(dtype), offsets,
                          backend=backend)


def _slab_groups(w) -> int:
    return int((w["wire"] if is_quantized(w) else w).shape[0])


def _grouped_ffn(xs, offsets, fc1, b1, fc2, b2, activation, dtype,
                 backend=None):
    """Expert FFN over ``xs`` ``[N, h]`` sorted by expert with segment
    ``offsets`` ``[G+1]``; per-row biases gather through a zero-padded
    table, so rows outside the window get none."""
    gid = group_ids(offsets, xs.shape[0], _slab_groups(fc1)).long()
    b2e = _GroupRows.apply(b2.to(dtype), gid)
    h1 = _expert_matmul(xs, fc1, offsets, dtype, backend)
    if activation == "swiglu":
        # fc1 is the concatenated [gate ‖ up] (2f wide); the per-row bias
        # keeps its own dtype into the op's fp32 sum, as in JAX
        h1 = fused_bias_swiglu(h1, _GroupRows.apply(b1, gid))
    else:
        h1 = mlp_gelu(activation, h1 + _GroupRows.apply(b1.to(dtype), gid))
    h2 = _expert_matmul(h1, fc2, offsets, dtype, backend)
    return h2 + b2e


def _sorted_assignment(choice, gates, e_n: int):
    """Flatten ``[T, k]`` assignments into the sorted-by-expert slot
    layout: ``(order [N], its inverse [N], offsets [E+1] int32,
    gates_sorted [N])`` with ``N = T·k``.  The offsets are ``searchsorted`` over the sorted
    expert ids (JAX counts with ``bincount``; ``torch.bincount`` reads
    the host)."""
    fe = choice.reshape(-1)
    order = torch.argsort(fe, stable=True)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    bounds = torch.arange(e_n + 1, dtype=fe.dtype, device=fe.device)
    offsets = torch.searchsorted(fe[order], bounds).to(torch.int32)
    return order, inv, offsets, _Permute.apply(gates.reshape(-1), order, inv)


def _ragged_local(params, x2, probs, top_k, activation, gmm_backend):
    """Sort by expert, grouped FFN, inverse-permutation combine:
    ``(out [T, h] in x2's dtype, counts [E] int32)``."""
    e_n = params["router"].shape[-1]
    t_n, h = x2.shape
    choice, gates = _topk_routing(probs, top_k)
    order, inv, offsets, gate_s = _sorted_assignment(choice, gates, e_n)
    # slot j of the flat [T·k] layout is token j // k: gathering through
    # the permutation (and not by token index) makes every backward a
    # gather too, with no scatter of repeated indices
    flat = x2[:, None, :].expand(t_n, top_k, h).reshape(t_n * top_k, h)
    xs = _Permute.apply(flat, order, inv)
    h2 = _grouped_ffn(xs, offsets, params["fc1"], params["fc1_bias"],
                      params["fc2"], params["fc2_bias"], activation,
                      x2.dtype, gmm_backend)
    contrib = gate_s[:, None] * h2.float()
    # each token's k slots, summed in slot order
    out = _Permute.apply(contrib, inv, order).reshape(t_n, top_k, h).sum(1)
    return out.to(x2.dtype), offsets[1:] - offsets[:-1]


# ---------------------------------------------------------------------------
# capacity (Switch drop-token) routing
# ---------------------------------------------------------------------------


def _capacity_moe(params, x, *, capacity_factor, top_k, noise_generator,
                  activation):
    b, s, h = x.shape
    e_n = params["router"].shape[-1]
    cap = max(1, math.ceil(top_k * s * capacity_factor / e_n))

    probs = _router_probs(params["router"], x.reshape(b * s, h),
                          noise_generator).reshape(b, s, e_n)

    dev = x.device
    combine = torch.zeros(b, s, e_n, cap, dtype=torch.float32, device=dev)
    remaining = probs
    position_in_expert = torch.zeros(b, e_n, dtype=torch.int32, device=dev)
    dropped = torch.zeros((), dtype=torch.float32, device=dev)
    sel_counts = torch.zeros(e_n, dtype=torch.float32, device=dev)
    for _ in range(top_k):
        choice = torch.argmax(remaining, dim=-1)                # [b, s]
        gate = torch.gather(remaining, -1, choice[..., None])[..., 0]
        onehot = F.one_hot(choice, e_n).float()                 # [b, s, E]
        sel_counts = sel_counts + onehot.sum(dim=(0, 1))
        # position of each token in its chosen expert's queue (fp32, as
        # the JAX cumsum)
        pos = torch.cumsum(onehot, dim=1) - 1.0
        pos_tok = (pos * onehot).sum(dim=-1) + torch.gather(
            position_in_expert.float(), -1, choice)
        keep = pos_tok < cap
        dropped = dropped + (~keep).sum() / (b * s * top_k)
        # one_hot of index cap is the zero row (jax.nn.one_hot)
        slot = F.one_hot(torch.where(keep, pos_tok, float(cap)).long(),
                         cap + 1)[..., :cap].float()            # [b, s, cap]
        combine = combine + (gate * keep)[..., None, None] \
            * onehot[..., None] * slot[:, :, None, :]
        position_in_expert = position_in_expert + (
            onehot * keep[..., None]).to(torch.int32).sum(dim=1)
        remaining = remaining * (1.0 - onehot)

    dispatch = (combine > 0.0).to(x.dtype)                      # [b,s,E,cap]
    expert_in = torch.einsum("bsec,bsh->ebch", dispatch, x)     # [E,b,cap,h]
    h1 = torch.einsum("ebch,ehf->ebcf", expert_in,
                      params["fc1"].to(x.dtype))
    if activation == "swiglu":
        # each expert's [2f] bias in its own dtype into the op's fp32 sum
        # (the JAX package vmaps fused_bias_swiglu over the experts)
        h1 = fused_bias_swiglu(h1, params["fc1_bias"][:, None, None, :])
    else:
        h1 = mlp_gelu(activation,
                      h1 + params["fc1_bias"][:, None, None, :].to(x.dtype))
    h2 = torch.einsum("ebcf,efh->ebch", h1, params["fc2"].to(x.dtype))
    h2 = h2 + params["fc2_bias"][:, None, None, :].to(x.dtype)
    out = torch.einsum("bsec,ebch->bsh", combine.to(x.dtype), h2)

    aux = _aux_loss(probs.mean(dim=(0, 1)), sel_counts, b * s * top_k)
    return MoEOutput(out=out.to(x.dtype), aux_loss=aux,
                     dropped_fraction=dropped, expert_load=sel_counts)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def switch_moe_mlp(params: dict, x: torch.Tensor, *,
                   capacity_factor: float = 1.25, top_k: int = 1,
                   ep_axis: Optional[str] = "ep",
                   router_noise_generator: Optional[torch.Generator] = None,
                   activation: str = "gelu", routing: str = "capacity",
                   moe_comm: str = "fp32", comm_block: int = 256,
                   overlap_comm: Optional[bool] = None, ep_mesh=None,
                   gmm_backend: Optional[str] = None) -> MoEOutput:
    """Token-choice top-k MoE FFN over ``x`` ``[b, s, h]``.

    ``routing="capacity"`` (default): each expert processes ``ceil(top_k
    · s · capacity_factor / E)`` token slots per batch row; tokens over
    capacity fall through with a zero update and are reported in
    ``dropped_fraction``.  ``routing="ragged"``: capacity-free, no token
    dropped (``dropped_fraction == 0``), the experts run over sorted
    ragged segments through the grouped matmul; ``capacity_factor`` is
    ignored.  Quantized expert slabs (``models/quantized.
    quantize_params``) need ``routing="ragged"`` and no expert mesh.
    ``gmm_backend="reference"`` pins the grouped matmul's plain version.
    ``moe_comm``/``comm_block`` configure the expert-parallel wire, which
    the distributed slice brings."""
    if routing not in MOE_ROUTINGS:
        raise ValueError(
            f"routing={routing!r}: expected one of {MOE_ROUTINGS}")
    if moe_comm not in WIRE_DTYPES:
        raise ValueError(
            f"moe_comm={moe_comm!r}: expected one of {WIRE_DTYPES}")
    if is_quantized(params.get("fc1")) or is_quantized(params.get("fc2")):
        if routing != "ragged":
            raise ValueError(
                "quantized expert slabs need routing='ragged' (the "
                "capacity einsum path has no int8 form)")
        if ep_mesh is not None:
            raise ValueError(
                "quantized expert slabs are a single-device serving "
                "path; run them outside an expert-parallel mesh")
    if ep_mesh is not None or (overlap_comm and ep_axis is not None):
        raise NotImplementedError(
            "the expert-parallel island (ep_mesh=, overlap_comm=True over "
            "an 'ep' axis) comes with the distributed-training slice of "
            "the port")
    if routing == "capacity":
        return _capacity_moe(
            params, x, capacity_factor=capacity_factor, top_k=top_k,
            noise_generator=router_noise_generator, activation=activation)

    b, s, h = x.shape
    x2 = x.reshape(b * s, h)
    _note_dropped(0.0)   # drop-free by construction
    probs = _router_probs(params["router"], x2, router_noise_generator)
    out2, counts = _ragged_local(params, x2, probs, top_k, activation,
                                 gmm_backend)
    load = counts.float()
    aux = _aux_loss(probs.mean(dim=0), load, b * s * top_k)
    return MoEOutput(out=out2.reshape(b, s, h).to(x.dtype), aux_loss=aux,
                     dropped_fraction=torch.zeros((), dtype=torch.float32,
                                                  device=x.device),
                     expert_load=load)
