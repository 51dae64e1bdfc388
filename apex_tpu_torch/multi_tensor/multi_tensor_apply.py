"""Batched elementwise ops over whole tensor lists
(``apex_tpu/multi_tensor/multi_tensor_apply.py``).

The reference's ``multi_tensor_applier`` dispatches CUDA kernels that
cover a list of tensors in one launch, with a shared ``noop_flag`` that
reports a non-finite value.  The JAX package keeps the semantics and
leaves the fusion to XLA.  Eager PyTorch fuses nothing, so here the
functions launch the hand-written kernels of ``csrc/multi_tensor.cu``
for CUDA tensors: one launch (one call of the kernel's C entry) for each
:data:`MAX_TENSORS` tensors of the list, so one for the stacked trees of
the repo's train steps, and more only for longer lists:

- :func:`multi_tensor_scale` (M1): ``out = src · scale``, the non-finite
  flag, a set incoming ``noop_flag`` passing the sources through
  unscaled;
- :func:`multi_tensor_axpby` (M1's other mode): ``a·x + b·y``;
- :func:`multi_tensor_l2norm` (M2): the global norm, and per tensor when
  asked, in fp32 and a fixed summation order;
- :func:`multi_tensor_adam` (M3) and :func:`multi_tensor_lamb` (M4's two
  stages): the optimizer updates of ``optimizers.fused_adam`` and
  ``optimizers.fused_lamb``, either returning the update (their
  ``GradientTransformation.update``) or applying it, with the model-dtype
  copy of each new parameter and the AMP step's overflow select in the
  same pass.

They are functional, as in JAX: results are returned, and an out-list
gives only dtypes.  CPU tensors, and ``backend="reference"``, run each
function's plain version, the per-tensor torch composition the kernels
repeat operation by operation; a CUDA tensor never falls back (a build or
launch failure raises).  The kernels take fp32, bf16 and fp16 tensors;
moments are fp32.  Scalars may be Python numbers or 0-d device tensors,
which the kernels read from device memory, so a train step makes no host
read.
"""

from __future__ import annotations

import ctypes
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.utils.registry import check_backend

__all__ = ["multi_tensor_scale", "multi_tensor_axpby", "multi_tensor_l2norm",
           "multi_tensor_adam", "multi_tensor_lamb", "MultiTensorApply",
           "multi_tensor_applier", "amp_C", "CHUNK", "MAX_TENSORS",
           "chunk_count", "kernel_attributes", "as_f32"]

# csrc/multi_tensor_apply.cuh: mt::kChunk, mt::kMaxTensors
CHUNK = 65536
MAX_TENSORS = 320
_SOURCE = "multi_tensor.cu"
_JAX = "apex_tpu/multi_tensor/multi_tensor_apply.py"
_c_int, _c_float, _ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

MT_SCALE = ku.register(ku.Kernel(
    "multi_tensor_scale", _SOURCE, "apex_mt_scale",
    [_ptr, _c_float, _ptr, _c_float, _ptr, _ptr, _ptr, _c_int],
    replaces=f"{_JAX}:47 (XLA in the JAX package; no TPU kernel)"))
MT_L2NORM = ku.register(ku.Kernel(
    "multi_tensor_l2norm", _SOURCE, "apex_mt_l2norm",
    [_ptr, _ptr, _ptr, _c_int, _ptr, _ptr],
    replaces=f"{_JAX}:95 (XLA in the JAX package; no TPU kernel)"))
MT_ADAM = ku.register(ku.Kernel(
    "multi_tensor_adam", _SOURCE, "apex_mt_adam",
    [_ptr, _c_float, _ptr] + [_c_float] * 6
    + [_ptr, _ptr, _ptr, _c_int, _c_int, _ptr, _ptr],
    replaces="apex_tpu/ops/flat_adam.py:38 (XLA in the JAX package; its "
             "Pallas kernel was deleted)"))
MT_LAMB = ku.register(ku.Kernel(
    "multi_tensor_lamb", _SOURCE, "apex_mt_lamb",
    [_ptr] + [_c_float] * 6 + [_ptr] * 3
    + [_c_int, _c_float, _ptr, _c_int, _c_int, _ptr, _ptr, _ptr],
    replaces="apex_tpu/optimizers/fused_lamb.py:67 (XLA in the JAX "
             "package; no TPU kernel)"))

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


# ---- the tensor table (csrc/multi_tensor_apply.cuh mt::Table<NL>) ----

_TABLES = {}


def _table_type(nl: int):
    """The ctypes mirror of ``mt::Table<nl>``, checked once against the
    built library's own sizeof/offsetof."""
    cls = _TABLES.get(nl)
    if cls is None:
        cls = type(f"Table{nl}", (ctypes.Structure,), {"_fields_": [
            ("n", ctypes.c_int), ("chunks", ctypes.c_int),
            ("start", ctypes.c_int * (MAX_TENSORS + 1)),
            ("numel", ctypes.c_longlong * MAX_TENSORS),
            ("ptr", (ctypes.c_void_p * MAX_TENSORS) * nl),
            ("code", (ctypes.c_ubyte * MAX_TENSORS) * nl),
            ("vec", ctypes.c_ubyte * MAX_TENSORS)]})
        got = (ctypes.c_longlong * 5)()
        err = ku.library(_SOURCE).apex_mt_layout(ctypes.c_int(nl), got)
        want = [ctypes.sizeof(cls)] + [getattr(cls, f).offset for f in
                                       ("numel", "ptr", "code", "vec")]
        if err != 0 or list(got) != want:
            raise RuntimeError(
                f"mt::Table<{nl}> layout {list(got)} (error {err}) differs "
                f"from its ctypes mirror {want}")
        _TABLES[nl] = cls
    return cls


def chunk_count(numel: int) -> int:
    """Chunks (CTAs) a tensor of ``numel`` elements takes."""
    return -(-int(numel) // CHUNK)


class _Group(NamedTuple):
    """One launch's share of a call: the table of the lists' tensors from
    index ``first``, and the call's chunks before it."""

    tab: Any
    first: int
    chunk0: int


def _groups(lists: Sequence[Sequence[Optional[torch.Tensor]]]
            ) -> Tuple[List[_Group], int]:
    """``(groups, chunks)``: the tables of ``len(lists)`` pointer lists of n
    tensors each (``None``: no tensor in that list at that index), one for
    each :data:`MAX_TENSORS` tensors (one table for an empty list), and
    the chunks of them all."""
    n = len(lists[0])
    groups, chunk0 = [], 0
    for first in range(0, max(n, 1), MAX_TENSORS):
        tab, chunks = _table([lst[first:first + MAX_TENSORS]
                              for lst in lists])
        groups.append(_Group(tab, first, chunk0))
        chunk0 += chunks
    return groups, chunk0


def _at(t: Optional[torch.Tensor], i: int) -> ctypes.c_void_p:
    """Device pointer of element ``i`` of a 1-D buffer (``NULL`` for
    ``None``)."""
    return ku.ptr(None if t is None else t[i:])


def _table(lists: Sequence[Sequence[Optional[torch.Tensor]]]):
    """``(table, chunks)`` over at most :data:`MAX_TENSORS` tensors."""
    nl, n = len(lists), len(lists[0])
    tab = _table_type(nl)()
    tab.n = n
    chunks = 0
    for t in range(n):
        ref = next(lst[t] for lst in lists if lst[t] is not None)
        tab.start[t] = chunks
        tab.numel[t] = ref.numel()
        chunks += chunk_count(ref.numel())
        vec = 1
        for li in range(nl):
            x = lists[li][t]
            if x is None:
                continue
            tab.ptr[li][t] = x.data_ptr()
            tab.code[li][t] = ku.DTYPE_CODES[x.dtype]
            vec &= int(x.data_ptr() % 16 == 0)
        tab.vec[t] = vec
    tab.start[n] = chunks
    tab.chunks = chunks
    return tab, chunks


def _route(tensors: Sequence[torch.Tensor], backend) -> Optional[torch.device]:
    """The CUDA device the kernels run on, or ``None`` for the plain
    version (CPU tensors, or ``backend="reference"``)."""
    check_backend(backend)
    devs = {t.device for t in tensors}
    if len(devs) > 1:
        raise ValueError(f"multi-tensor operands on {sorted(map(str, devs))}")
    if backend == "reference" or not devs:
        return None
    dev = devs.pop()
    return dev if dev.type == "cuda" else None


def _kernel_input(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what}: the multi-tensor kernels take float32, "
                        f"bfloat16 or float16 tensors, got {t.dtype}")
    return t.contiguous()


def _scalar_arg(value, dev) -> Tuple[float, Any, Optional[torch.Tensor]]:
    """(host value, device pointer, the fp32 device tensor kept alive) of a
    Python number or a 0-d tensor; a tensor is read by the kernel."""
    if torch.is_tensor(value):
        t = value.reshape(()).to(device=dev, dtype=torch.float32)
        return 0.0, ku.ptr(t), t
    return float(value), ku.ptr(None), None


# ---- M1: scale and axpby ----

def _nonfinite_flag(tensors: Sequence[torch.Tensor], dev) -> torch.Tensor:
    """int32 0/1: 1 iff any element of any tensor is not finite."""
    if not tensors:
        return torch.zeros((), dtype=torch.int32, device=dev)
    flags = [~torch.isfinite(t.float()).all() for t in tensors]
    return torch.stack(flags).any().to(torch.int32)


def _launch_scale(dev, xs, ys, out_dtypes, a, b, noop, axpby: bool):
    """One M1 launch: ``(outs, flag)``; ``out_dtypes=None`` only checks."""
    xs = [_kernel_input(x, "multi_tensor_scale") for x in xs]
    ys = [_kernel_input(y, "multi_tensor_axpby") for y in ys] if axpby \
        else [None] * len(xs)
    outs = ([None] * len(xs) if out_dtypes is None else
            [torch.empty(x.shape, dtype=dt, device=dev)
             for x, dt in zip(xs, out_dtypes)])
    for o in outs:
        if o is not None and o.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"multi_tensor_scale: out dtype {o.dtype}")
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    noop_t = (None if noop is None else
              noop.reshape(()).to(device=dev, dtype=torch.int32))
    a_host, a_ptr, a_keep = _scalar_arg(a, dev)
    b_host, b_ptr, b_keep = _scalar_arg(b, dev)
    for grp in _groups([xs, ys, outs])[0]:
        MT_SCALE(dev, ctypes.addressof(grp.tab), a_host, a_ptr, b_host,
                 b_ptr, ku.ptr(noop_t), ku.ptr(flag), int(axpby))
    del a_keep, b_keep
    return outs, flag


def multi_tensor_scale(srcs: Sequence[torch.Tensor], scale,
                       noop_flag: Optional[torch.Tensor] = None,
                       out_dtypes: Optional[Sequence[Any]] = None, *,
                       backend: Optional[str] = None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``out[i] = src[i] * scale`` in fp32, then cast to ``out_dtypes[i]``
    (default: the source's dtype), and an int32 flag, 1 when any source
    holds a non-finite value or ``noop_flag`` is set.  A set
    ``noop_flag`` passes the sources through unscaled (the reference
    kernel's early exit)."""
    srcs = list(srcs)
    out_dtypes = list(out_dtypes or [t.dtype for t in srcs])
    dev = _route(srcs, backend)
    if dev is not None:
        return _launch_scale(dev, srcs, [], out_dtypes, scale, 0.0,
                             noop_flag, axpby=False)
    where = srcs[0].device if srcs else None
    flag = _nonfinite_flag(srcs, where)
    if noop_flag is not None:
        flag = torch.maximum(flag, noop_flag.to(torch.int32))
    outs = []
    for t, dt in zip(srcs, out_dtypes):
        scaled = (t.float() * scale).to(dt)
        if noop_flag is not None:
            scaled = torch.where(noop_flag.bool(), t.to(dt), scaled)
        outs.append(scaled)
    return outs, flag


def multi_tensor_axpby(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor],
                       a, b, out_dtypes: Optional[Sequence[Any]] = None, *,
                       backend: Optional[str] = None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``out[i] = a·x[i] + b·y[i]`` in fp32, cast to ``out_dtypes[i]``
    (default: x's dtype), and the int32 non-finite flag of xs and ys."""
    xs, ys = list(xs), list(ys)
    out_dtypes = list(out_dtypes or [t.dtype for t in xs])
    dev = _route(xs + ys, backend)
    if dev is not None:
        return _launch_scale(dev, xs, ys, out_dtypes, a, b, None, axpby=True)
    where = xs[0].device if xs else None
    flag = torch.maximum(_nonfinite_flag(xs, where),
                         _nonfinite_flag(ys, where))
    outs = [(a * x.float() + b * y.float()).to(dt)
            for x, y, dt in zip(xs, ys, out_dtypes)]
    return outs, flag


def all_finite_flag(tensors: Sequence[torch.Tensor], *,
                    backend: Optional[str] = None) -> torch.Tensor:
    """The int32 non-finite flag of :func:`multi_tensor_scale` alone (M1
    with no output written)."""
    tensors = list(tensors)
    dev = _route(tensors, backend)
    if dev is not None:
        return _launch_scale(dev, tensors, [], None, 1.0, 0.0, None,
                             axpby=False)[1]
    return _nonfinite_flag(tensors, tensors[0].device if tensors else None)


# ---- M2: L2 norms ----

def multi_tensor_l2norm(tensors: Sequence[torch.Tensor],
                        per_tensor: bool = False, *,
                        backend: Optional[str] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(global norm, per-tensor norms or None)`` over a tensor list, in
    fp32.  The kernel adds per-chunk partial sums in a fixed order, so a
    repeat gives the same bits, and a list longer than
    :data:`MAX_TENSORS` gives the bits it would in one table."""
    tensors = list(tensors)
    dev = _route(tensors, backend)
    if dev is None:
        where = tensors[0].device if tensors else None
        if not tensors:
            z = torch.zeros((), dtype=torch.float32, device=where)
            return z, (torch.zeros((0,), dtype=torch.float32, device=where)
                       if per_tensor else None)
        sq = torch.stack([torch.sum(torch.square(t.float()))
                          for t in tensors])
        return torch.sqrt(torch.sum(sq)), (torch.sqrt(sq) if per_tensor
                                           else None)
    xs = [_kernel_input(t if t.is_floating_point() else t.float(),
                        "multi_tensor_l2norm") for t in tensors]
    groups, chunks = _groups([xs])
    partial = torch.empty(max(chunks, 1), dtype=torch.float32, device=dev)
    sq = torch.empty(max(len(xs), 1), dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    per = (torch.empty(len(xs), dtype=torch.float32, device=dev)
           if per_tensor else None)
    for grp in groups:
        MT_L2NORM(dev, ctypes.addressof(grp.tab), _at(partial, grp.chunk0),
                  ku.ptr(sq), grp.first, ku.ptr(per),
                  ku.ptr(total if grp is groups[-1] else None))
    return total, per


# ---- M3: Adam ----

class MultiTensorOut(NamedTuple):
    """What :func:`multi_tensor_adam` and :func:`multi_tensor_lamb` return:
    ``params`` holds the updates (fp32) in update mode and the new
    parameters (each in its parameter's dtype) in apply mode; ``model``
    the model-dtype copies asked for (``None`` where none was); and
    ``update_sq`` the sum of the updates' squares (a 0-d fp32 tensor) when
    ``update_norm=True``."""

    params: List[torch.Tensor]
    exp_avg: List[torch.Tensor]
    exp_avg_sq: List[torch.Tensor]
    model: List[Optional[torch.Tensor]]
    update_sq: Optional[torch.Tensor]


def as_f32(value, dev) -> torch.Tensor:
    """A 0-d fp32 tensor on ``dev``; a Python number is filled there (no
    host-to-device copy, which a CUDA-graph capture refuses)."""
    if torch.is_tensor(value):
        return value.to(device=dev, dtype=torch.float32)
    return torch.full((), value, dtype=torch.float32, device=dev)


def _apply_plain(updates, params, m, v, exp_avgs, exp_avg_sqs, overflow,
                 model_dtypes, update_norm):
    """The AMP step's per-leaf tail over lists (``optimizers._common.
    apply_or_keep``, the tail of every optimizer without a multi-tensor
    kernel), the cast to each model dtype, and the updates' sum of
    squares."""
    # _common imports this module
    from apex_tpu_torch.optimizers._common import apply_or_keep

    usq = _sum_sq(updates, params) if update_norm else None
    new_p, (m, v) = apply_or_keep(params, updates, (m, v),
                                  (exp_avgs, exp_avg_sqs), overflow)
    dts = model_dtypes or [None] * len(new_p)
    model = [None if dt is None else p.to(dt) for p, dt in zip(new_p, dts)]
    return MultiTensorOut(new_p, m, v, model, usq)


def _sum_sq(updates, params) -> torch.Tensor:
    """Sum of the updates' squares, a 0-d fp32 tensor."""
    if not updates:
        return torch.zeros((), dtype=torch.float32,
                           device=params[0].device if params else None)
    return sum(torch.sum(torch.square(u)) for u in updates)


def _plain_out(ups, ms, vs, params, exp_avgs, exp_avg_sqs, apply, overflow,
               model_dtypes, update_norm) -> MultiTensorOut:
    if apply:
        return _apply_plain(ups, params, ms, vs, exp_avgs, exp_avg_sqs,
                            overflow, model_dtypes, update_norm)
    return MultiTensorOut(ups, ms, vs, [None] * len(ups),
                          _sum_sq(ups, params) if update_norm else None)


def _adam_plain(grads, params, exp_avgs, exp_avg_sqs, lr, beta1, beta2, eps,
                weight_decay, adam_w_mode, bc1, bc2):
    """Per-leaf Adam (``apex_tpu/optimizers/fused_adam.py:117-142``):
    ``(updates, m, v)``, every value fp32."""
    def adj_grad(g, p):
        g32 = g.float()
        if not adam_w_mode and weight_decay != 0.0:
            g32 = g32 + weight_decay * p.float()
        return g32

    ups, ms, vs = [], [], []
    for g, p, m, v in zip(grads, params, exp_avgs, exp_avg_sqs):
        m_new = beta1 * m + (1.0 - beta1) * adj_grad(g, p)
        v_new = beta2 * v + (1.0 - beta2) * torch.square(adj_grad(g, p))
        denom = torch.sqrt(v_new / bc2) + eps
        upd = -lr * (m_new / bc1) / denom
        if adam_w_mode and weight_decay != 0.0:
            upd = upd - lr * weight_decay * p.float()
        ups.append(upd)
        ms.append(m_new)
        vs.append(v_new)
    return ups, ms, vs


def _outputs(dev, params, apply: bool, model_dtypes):
    """New-parameter (or update), moment and model-copy buffers."""
    p_out = [torch.empty(p.shape, dtype=p.dtype if apply else torch.float32,
                         device=dev) for p in params]
    m_out = [torch.empty(p.shape, dtype=torch.float32, device=dev)
             for p in params]
    v_out = [torch.empty(p.shape, dtype=torch.float32, device=dev)
             for p in params]
    model = [None] * len(params)
    if apply and model_dtypes is not None:
        for i, (p, dt) in enumerate(zip(params, model_dtypes)):
            if dt is not None:
                if dt not in _KERNEL_DTYPES:
                    raise TypeError(f"model dtype {dt}")
                model[i] = (p_out[i] if dt == p.dtype else
                            torch.empty(p.shape, dtype=dt, device=dev))
    return p_out, m_out, v_out, model


def _moment_inputs(exp_avgs, exp_avg_sqs):
    for t in list(exp_avgs) + list(exp_avg_sqs):
        if t.dtype != torch.float32:
            raise TypeError(f"optimizer moments must be float32, got {t.dtype}")
    return ([t.contiguous() for t in exp_avgs],
            [t.contiguous() for t in exp_avg_sqs])


def _flag_arg(overflow, dev):
    if overflow is None:
        return None
    return overflow.reshape(()).to(device=dev, dtype=torch.bool)


def _usq_sum(usq: Optional[torch.Tensor], chunks: int, dev):
    if usq is None:
        return None
    if chunks == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    return usq.sum()


def _hyper_args(beta1, beta2, gm, eps, weight_decay):
    """The six host floats of ``mt::Hyper``: beta1, beta2, the gradient's
    weight in m, 1 - beta2, eps, weight decay."""
    return (beta1, beta2, gm, 1.0 - beta2, eps, weight_decay)


def multi_tensor_adam(grads: Sequence[torch.Tensor],
                      params: Sequence[torch.Tensor],
                      exp_avgs: Sequence[torch.Tensor],
                      exp_avg_sqs: Sequence[torch.Tensor], *, lr,
                      betas: Tuple[float, float], eps: float,
                      weight_decay: float, adam_w_mode: bool,
                      bc1: Optional[torch.Tensor] = None,
                      bc2: Optional[torch.Tensor] = None, apply: bool = False,
                      overflow: Optional[torch.Tensor] = None,
                      model_dtypes: Optional[Sequence[Any]] = None,
                      update_norm: bool = False,
                      backend: Optional[str] = None,
                      hyper_dev: Optional[torch.Tensor] = None
                      ) -> MultiTensorOut:
    """Adam/AdamW over the lists (M3): ``lr`` a number or a 0-d tensor,
    ``bc1``/``bc2`` the bias corrections as 0-d tensors (``None``: 1).
    Update mode returns the fp32 updates; ``apply=True`` returns ``p +
    u`` in p's dtype, keeps p, m and v bit for bit where the 0-d bool
    ``overflow`` is set, and writes ``model_dtypes[i]`` copies of the new
    parameters (``None`` entries: no copy).  ``hyper_dev``, an fp32 ``[6]``
    tensor ``[beta1, beta2, 1 - beta1, 1 - beta2, eps, weight_decay]``
    (``mt::Hyper``), is read on the card in place of ``betas``, ``eps``
    and ``weight_decay`` (``ops.flat_adam``, whose scalars are device
    values; its plain version is ``flat_adam``'s own)."""
    grads, params = list(grads), list(params)
    exp_avgs, exp_avg_sqs = list(exp_avgs), list(exp_avg_sqs)
    beta1, beta2 = betas
    dev = _route(grads + params + exp_avgs + exp_avg_sqs, backend)
    if dev is None:
        where = params[0].device if params else None
        lr_t = as_f32(lr, where)
        one = torch.ones((), dtype=torch.float32, device=where)
        ups, ms, vs = _adam_plain(grads, params, exp_avgs, exp_avg_sqs, lr_t,
                                  beta1, beta2, eps, weight_decay,
                                  adam_w_mode, one if bc1 is None else bc1,
                                  one if bc2 is None else bc2)
        return _plain_out(ups, ms, vs, params, exp_avgs, exp_avg_sqs, apply,
                          overflow, model_dtypes, update_norm)
    g_in = [_kernel_input(g, "multi_tensor_adam") for g in grads]
    p_in = [_kernel_input(p, "multi_tensor_adam") for p in params]
    m_in, v_in = _moment_inputs(exp_avgs, exp_avg_sqs)
    p_out, m_out, v_out, model = _outputs(dev, p_in, apply, model_dtypes)
    # a model copy that is the new parameter itself needs no second write
    model_ptrs = [None if mo is None or mo is po else mo
                  for mo, po in zip(model, p_out)]
    groups, chunks = _groups([g_in, p_in, m_in, v_in, p_out, m_out, v_out,
                              model_ptrs])
    usq = (torch.empty(max(chunks, 1), dtype=torch.float32, device=dev)
           if update_norm else None)
    lr_host, lr_ptr, lr_keep = _scalar_arg(lr, dev)
    ov = _flag_arg(overflow, dev) if apply else None
    hyper = _hyper_args(beta1, beta2, 1.0 - beta1, eps, weight_decay)
    h_dev = None if hyper_dev is None else hyper_dev.to(
        device=dev, dtype=torch.float32).contiguous()
    for grp in groups:
        MT_ADAM(dev, ctypes.addressof(grp.tab), lr_host, lr_ptr, *hyper,
                ku.ptr(h_dev), ku.ptr(bc1), ku.ptr(bc2), int(adam_w_mode),
                int(not apply), ku.ptr(ov), _at(usq, grp.chunk0))
    del lr_keep
    return MultiTensorOut(p_out, m_out, v_out, model,
                          _usq_sum(usq, chunks, dev))


# ---- M4: LAMB ----

def _lamb_plain(grads, params, exp_avgs, exp_avg_sqs, lr, beta1, beta2,
                beta3, eps, weight_decay, adam_w_mode, use_ratio, bc1, bc2,
                clip):
    """Per-leaf LAMB (``apex_tpu/optimizers/fused_lamb.py:87-120``) after
    the global clip: ``(updates, m, v)``, every value fp32."""
    def scaled_grad(g, p):
        sg = g.float() / clip
        if not adam_w_mode and weight_decay != 0.0:
            sg = sg + weight_decay * p.float()
        return sg

    ups, ms, vs = [], [], []
    for g, p, m, v in zip(grads, params, exp_avgs, exp_avg_sqs):
        m_new = beta1 * m + beta3 * scaled_grad(g, p)
        v_new = beta2 * v + (1.0 - beta2) * torch.square(scaled_grad(g, p))
        p32 = p.float()
        u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if adam_w_mode and weight_decay != 0.0:
            u = u + weight_decay * p32
        if not use_ratio:
            ups.append(-lr * u)
        else:
            w_norm = torch.sqrt(torch.sum(torch.square(p32)))
            u_norm = torch.sqrt(torch.sum(torch.square(u)))
            ratio = torch.where((w_norm > 0) & (u_norm > 0),
                                w_norm / u_norm, 1.0)
            ups.append(-lr * ratio * u)
        ms.append(m_new)
        vs.append(v_new)
    return ups, ms, vs


def multi_tensor_lamb(grads: Sequence[torch.Tensor],
                      params: Sequence[torch.Tensor],
                      exp_avgs: Sequence[torch.Tensor],
                      exp_avg_sqs: Sequence[torch.Tensor], *, lr,
                      betas: Tuple[float, float], beta3: float, eps: float,
                      weight_decay: float, adam_w_mode: bool, use_ratio: bool,
                      bc1: Optional[torch.Tensor] = None,
                      bc2: Optional[torch.Tensor] = None,
                      clip: Optional[torch.Tensor] = None, apply: bool = False,
                      overflow: Optional[torch.Tensor] = None,
                      model_dtypes: Optional[Sequence[Any]] = None,
                      update_norm: bool = False,
                      backend: Optional[str] = None) -> MultiTensorOut:
    """LAMB over the lists (M4, one call of the entry, two launches, for
    each :data:`MAX_TENSORS` tensors): gradients divided by the 0-d
    ``clip`` (``None``: 1), the moments, ``u = m̂ / (sqrt(v̂) + eps)``
    (+ ``weight_decay · p`` in AdamW mode), and ``-lr · ratio · u`` with
    one trust ratio ``|p| / |u|`` per tensor (1 where either norm is 0 or
    ``use_ratio`` is False).  Modes and outputs as :func:`multi_tensor_adam`."""
    grads, params = list(grads), list(params)
    exp_avgs, exp_avg_sqs = list(exp_avgs), list(exp_avg_sqs)
    beta1, beta2 = betas
    dev = _route(grads + params + exp_avgs + exp_avg_sqs, backend)
    if dev is None:
        where = params[0].device if params else None
        one = torch.ones((), dtype=torch.float32, device=where)
        ups, ms, vs = _lamb_plain(
            grads, params, exp_avgs, exp_avg_sqs, as_f32(lr, where), beta1,
            beta2, beta3, eps, weight_decay, adam_w_mode, use_ratio,
            one if bc1 is None else bc1, one if bc2 is None else bc2,
            one if clip is None else clip)
        return _plain_out(ups, ms, vs, params, exp_avgs, exp_avg_sqs, apply,
                          overflow, model_dtypes, update_norm)
    g_in = [_kernel_input(g, "multi_tensor_lamb") for g in grads]
    p_in = [_kernel_input(p, "multi_tensor_lamb") for p in params]
    m_in, v_in = _moment_inputs(exp_avgs, exp_avg_sqs)
    p_out, m_out, v_out, model = _outputs(dev, p_in, apply, model_dtypes)
    model_ptrs = [None if mo is None or mo is po else mo
                  for mo, po in zip(model, p_out)]
    # u: one fp32 scratch buffer, each tensor's slice at a 16-byte offset
    sizes = [-(-p.numel() // 4) * 4 for p in p_in]
    scratch = torch.empty(max(sum(sizes), 1), dtype=torch.float32,
                          device=dev)
    u_views, off = [], 0
    for p, size in zip(p_in, sizes):
        u_views.append(scratch[off:off + p.numel()].view(p.shape))
        off += size
    groups, chunks = _groups([g_in, p_in, m_in, v_in, p_out, m_out, v_out,
                              model_ptrs, u_views])
    # each launch's partials: |u|^2 of its chunks, then |p|^2
    partial = torch.empty(max(2 * chunks, 1), dtype=torch.float32,
                          device=dev)
    usq = (torch.empty(max(chunks, 1), dtype=torch.float32, device=dev)
           if update_norm else None)
    ov = _flag_arg(overflow, dev) if apply else None
    clip_t = (None if clip is None else
              clip.reshape(()).to(device=dev, dtype=torch.float32))
    lr_host, lr_ptr, lr_keep = _scalar_arg(lr, dev)
    hyper = _hyper_args(beta1, beta2, beta3, eps, weight_decay)
    for grp in groups:
        MT_LAMB(dev, ctypes.addressof(grp.tab), *hyper, ku.ptr(bc1),
                ku.ptr(bc2), ku.ptr(clip_t), int(adam_w_mode), lr_host,
                lr_ptr, int(use_ratio), int(not apply), ku.ptr(ov),
                _at(partial, 2 * grp.chunk0), _at(usq, grp.chunk0))
    del lr_keep
    return MultiTensorOut(p_out, m_out, v_out, model,
                          _usq_sum(usq, chunks, dev))


def kernel_attributes() -> dict:
    """``{kernel: {"registers", "smem_bytes", "ctas_per_sm",
    "spill_bytes"}}`` of the six kernels of ``csrc/multi_tensor.cu``
    (``apex_mt_attrs``).  Needs the card."""
    names = ("scale", "l2norm_partial", "l2norm_finish", "adam",
             "lamb_stage1", "lamb_stage2")
    out = {}
    for i, name in enumerate(names):
        vals = (ctypes.c_int * len(ku.ATTR_KEYS))()
        err = ku.library(_SOURCE).apex_mt_attrs(ctypes.c_int(i), vals)
        if err != 0:
            raise RuntimeError(f"apex_mt_attrs({i}): cudaError {err}")
        out[name] = dict(zip(ku.ATTR_KEYS, vals))
    return out


# ---- the reference's calling conventions ----

class MultiTensorApply:
    """``multi_tensor_applier(op, noop_flag, lists, *args)`` as in the
    reference: ``op(noop_flag, tensor_lists, *args) -> (out_lists, flag)``
    (the :data:`amp_C` functions).  Functional: results are returned, and
    an out-list contributes only its dtypes."""

    available = True

    def __init__(self, chunk_size: int = 2048 * 32):
        # the kernels' chunk is fixed (CHUNK); kept for the signature
        self.chunk_size = chunk_size

    def __call__(self, op, noop_flag, tensor_lists, *args):
        return op(noop_flag, tensor_lists, *args)


multi_tensor_applier = MultiTensorApply()


class _AmpC:
    """Conventional-signature functions named after the reference's
    ``amp_C`` module, for one-to-one porting of its call sites through
    :data:`multi_tensor_applier`."""

    @staticmethod
    def multi_tensor_scale(noop_flag, tensor_lists, scale):
        # [srcs, outs]: outs give the output dtypes
        srcs = tensor_lists[0]
        outs = tensor_lists[1] if len(tensor_lists) > 1 else srcs
        return multi_tensor_scale(srcs, scale, noop_flag,
                                  out_dtypes=[t.dtype for t in outs])

    @staticmethod
    def multi_tensor_axpby(noop_flag, tensor_lists, a, b, arg_to_check=-1):
        # [xs, ys, outs]; arg_to_check kept for the signature
        xs, ys = tensor_lists[0], tensor_lists[1]
        outs = tensor_lists[2] if len(tensor_lists) > 2 else xs
        out_lists, flag = multi_tensor_axpby(
            xs, ys, a, b, out_dtypes=[t.dtype for t in outs])
        if noop_flag is not None:
            flag = torch.maximum(flag, torch.as_tensor(
                noop_flag, dtype=torch.int32, device=flag.device))
        return out_lists, flag

    @staticmethod
    def multi_tensor_l2norm(noop_flag, tensor_lists, per_tensor=False):
        return multi_tensor_l2norm(tensor_lists[0], per_tensor=per_tensor)


amp_C = _AmpC()
