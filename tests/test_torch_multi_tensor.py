"""The port's multi-tensor layer (apex_tpu_torch.multi_tensor, ops.flat_adam)
against the JAX package's (apex_tpu.multi_tensor, apex_tpu.ops.flat_adam)
on the CPU, where every function runs its plain version: the cases of
tests/test_optimizers.py::TestMultiTensor (scale and flag, axpby, l2norm,
the applier and amp_C patterns) plus the noop pass-through, per-tensor
norms, mixed dtypes and the flat Adam buffer, on the same numpy inputs.

Both sides compute in fp32 from the same values; sums run in another
order, and XLA contracts multiply-adds, so norms are held to 1e-6
relative, the flat Adam results to 1e-5 relative with a 1e-8 floor for
the elements where a sum nearly cancels (measured: 1.3e-5 relative at
6.6e-9 absolute, on 6 of 1000 elements), and casts to exact equality.
The CUDA kernels behind these functions are held against the same plain
versions on the card (tests/test_torch_kernels.py, ``-k test_mt_``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor import amp_C as j_amp_C
from apex_tpu.multi_tensor import multi_tensor_applier as j_applier
from apex_tpu.multi_tensor import multi_tensor_axpby as j_axpby
from apex_tpu.multi_tensor import multi_tensor_l2norm as j_l2norm
from apex_tpu.multi_tensor import multi_tensor_scale as j_scale
from apex_tpu.ops.flat_adam import adam_kernel_flat as j_adam_flat
from apex_tpu.ops.flat_adam import flat_adam_update as j_flat_update
from apex_tpu_torch.multi_tensor import (
    MultiTensorApply, amp_C, multi_tensor_applier, multi_tensor_axpby,
    multi_tensor_l2norm, multi_tensor_scale)
from apex_tpu_torch.ops import flat_adam_update
from apex_tpu_torch.ops.flat_adam import adam_kernel_flat

_J = {np.float32: jnp.float32, np.float16: jnp.float16}


def _arrays(seed, dtype=np.float32, sizes=(5, 0, 17, 300)):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n) * 3).astype(dtype) for n in sizes]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


def _t(xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _np(t):
    return np.asarray(t.float() if torch.is_tensor(t) else t, np.float32)


# ---- tests/test_optimizers.py::TestMultiTensor, against JAX ----

def test_scale_and_flag():
    outs, flag = multi_tensor_scale(_t([np.array([2.0, 4.0], np.float32),
                                        np.array([6.0], np.float32)]), 0.5)
    np.testing.assert_allclose(outs[0].numpy(), [1.0, 2.0])
    np.testing.assert_allclose(outs[1].numpy(), [3.0])
    assert int(flag) == 0 and flag.dtype == torch.int32
    _, flag = multi_tensor_scale([torch.tensor([float("inf")])], 1.0)
    assert int(flag) == 1


@pytest.mark.parametrize("bad", [None, "inf", "nan"])
@pytest.mark.parametrize("out_dtype", [np.float32, np.float16])
def test_scale_matches_jax(bad, out_dtype):
    xs = _arrays(1, np.float16)
    if bad is not None:
        xs[2][4] = np.float16(bad)
    jo, jf = j_scale(_j(xs), 0.25, out_dtypes=[_J[out_dtype]] * len(xs))
    to, tf = multi_tensor_scale(
        _t(xs), 0.25, out_dtypes=[getattr(torch, np.dtype(out_dtype).name)]
        * len(xs))
    assert int(tf) == int(jf) == (bad is not None)
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))


@pytest.mark.parametrize("noop", [0, 1])
def test_scale_noop_flag_passes_through(noop):
    """A set incoming flag passes the sources through unscaled and is
    OR'ed into the result, as JAX's (the reference kernel's early exit)."""
    xs = _arrays(2)
    jo, jf = j_scale(_j(xs), 4.0, jnp.asarray(noop, jnp.int32))
    to, tf = multi_tensor_scale(_t(xs), 4.0,
                                torch.tensor(noop, dtype=torch.int32))
    assert int(tf) == int(jf) == noop
    for a, b, x in zip(to, jo, xs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if noop:
            np.testing.assert_array_equal(a.numpy(), x)


def test_axpby():
    outs, flag = multi_tensor_axpby([torch.tensor([1.0, 2.0])],
                                    [torch.tensor([10.0, 20.0])], 2.0, 0.5)
    np.testing.assert_allclose(outs[0].numpy(), [7.0, 14.0])
    assert int(flag) == 0


def test_axpby_matches_jax_mixed_dtypes():
    xs, ys = _arrays(3, np.float16), _arrays(4)
    ys[3][7] = np.nan
    jo, jf = j_axpby(_j(xs), _j(ys), 1.5, -0.5,
                     out_dtypes=[jnp.float32] * len(xs))
    to, tf = multi_tensor_axpby(_t(xs), _t(ys), 1.5, -0.5,
                                out_dtypes=[torch.float32] * len(xs))
    assert int(tf) == int(jf) == 1
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_l2norm():
    total, per = multi_tensor_l2norm([torch.tensor([3.0]),
                                      torch.tensor([4.0])], per_tensor=True)
    np.testing.assert_allclose(float(total), 5.0)
    np.testing.assert_allclose(per.numpy(), [3.0, 4.0])


@pytest.mark.parametrize("per_tensor", [False, True])
def test_l2norm_matches_jax(per_tensor):
    xs = _arrays(5) + _arrays(6, np.float16)
    jt, jp = j_l2norm(_j(xs), per_tensor=per_tensor)
    tt, tp = multi_tensor_l2norm(_t(xs), per_tensor=per_tensor)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    assert (tp is None) == (jp is None)
    if per_tensor:
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    zt, zp = multi_tensor_l2norm([], per_tensor=True)
    assert float(zt) == 0.0 and zp.shape == (0,)


def test_applier_reference_pattern():
    # the calling pattern of the reference's apex/amp/scaler.py:114-126
    model_grads = [torch.tensor([2.0, 4.0], dtype=torch.float16)]
    master_grads = [torch.tensor([0.0, 0.0])]
    outs, flag = multi_tensor_applier(
        amp_C.multi_tensor_scale, torch.zeros((), dtype=torch.int32),
        [model_grads, master_grads], 0.5)
    jouts, jflag = j_applier(
        j_amp_C.multi_tensor_scale, jnp.zeros((), jnp.int32),
        [[jnp.asarray([2.0, 4.0], jnp.float16)],
         [jnp.asarray([0.0, 0.0], jnp.float32)]], 0.5)
    assert outs[0].dtype == torch.float32
    np.testing.assert_allclose(outs[0].numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(outs[0].numpy(), np.asarray(jouts[0]))
    assert int(flag) == int(jflag) == 0


def test_applier_axpby_and_l2norm_patterns():
    xs = [torch.tensor([1.0, 2.0])]
    ys = [torch.tensor([10.0, 20.0])]
    outs, flag = multi_tensor_applier(
        amp_C.multi_tensor_axpby, torch.ones((), dtype=torch.int32),
        [xs, ys, xs], 2.0, 0.5, -1)
    np.testing.assert_allclose(outs[0].numpy(), [7.0, 14.0])
    assert int(flag) == 1            # the incoming flag is OR'ed in
    total, _ = multi_tensor_applier(amp_C.multi_tensor_l2norm, None,
                                    [[torch.tensor([3.0, 4.0])]])
    assert float(total) == 5.0
    assert MultiTensorApply.available
    assert MultiTensorApply(1024).chunk_size == 1024


# ---- ops/flat_adam.py ----

@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_kernel_flat_matches_jax(adam_w_mode):
    rng = np.random.RandomState(7)
    n = 1000
    g, p = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    m = (rng.randn(n) * 0.1).astype(np.float32)
    v = (rng.rand(n) * 0.01).astype(np.float32)
    scalars = np.array([1e-3, 0.9, 0.999, 1e-8, 0.05, 0.271, 0.00399],
                       np.float32)
    want = j_adam_flat(*map(jnp.asarray, (g, p, m, v, scalars)),
                       adam_w_mode=adam_w_mode)
    got = adam_kernel_flat(*_t([g, p, m, v, scalars]),
                           adam_w_mode=adam_w_mode)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-8)


def test_flat_adam_update_matches_jax_and_returns_views():
    rng = np.random.RandomState(8)
    shapes = {"a": (4, 8), "b": (8,), "c": (3, 5, 2)}
    tree = lambda s: {k: (rng.randn(*v) * s).astype(np.float32)  # noqa: E731
                      for k, v in shapes.items()}
    g, p, m = tree(1.0), tree(1.0), tree(0.1)
    v = {k: np.abs(x) * 0.01 for k, x in tree(1.0).items()}
    args = (1e-2, 0.9, 0.999, 1e-8, 0.05, 0.19, 0.002997, True)
    jt = lambda d: {k: jnp.asarray(x) for k, x in d.items()}  # noqa: E731
    tt = lambda d: {k: torch.from_numpy(x) for k, x in d.items()}  # noqa: E731
    want = j_flat_update(jt(g), jt(p), jt(m), jt(v), *args)
    got = flat_adam_update(tt(g), tt(p), tt(m), tt(v), *args)
    for w_tree, g_tree in zip(want, got):
        bases = {t.untyped_storage().data_ptr() for t in g_tree.values()}
        assert len(bases) == 1            # views of one flat result
        for k in shapes:
            assert g_tree[k].shape == shapes[k]
            np.testing.assert_allclose(g_tree[k].numpy(),
                                       np.asarray(w_tree[k]), rtol=1e-5,
                                       atol=1e-8)
