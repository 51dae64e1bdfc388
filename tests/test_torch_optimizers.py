"""The port's optimizers (apex_tpu_torch.optimizers: FusedAdam tree and flat
paths, FusedSGD, FusedAdagrad, FusedNovoGrad, FusedLARS) against the JAX
package's on the CPU: the cases of tests/test_optimizers.py (TestFusedAdam,
TestFusedSGD, TestFusedAdagrad, TestFusedNovoGrad, TestFusedLARS), each
optimizer stepped 3 times on the same numpy trees on both sides, the
parameters, updates and state held at 1e-6 absolute and 1e-5 relative
(fp32 on both sides, operations in another order), the validation errors
the same.  The fused tail (``fused_apply``, the AMP step's update, overflow
select and model copy in one pass) is held against ``update`` + ``p + u``
+ select + cast, its plain version on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import optimizers as jopt
from apex_tpu_torch import optimizers as topt

STEPS = 3
ATOL, RTOL = 1e-6, 1e-5


def _problem(seed, shapes=((4, 8), (8,), (3, 5, 2))):
    rng = np.random.RandomState(seed)
    params = {f"p{i}": rng.randn(*s).astype(np.float32)
              for i, s in enumerate(shapes)}
    grads = [{f"p{i}": rng.randn(*s).astype(np.float32)
              for i, s in enumerate(shapes)} for _ in range(STEPS)]
    return params, grads


def _jt(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _tt(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _state_leaves(state):
    """The float arrays of a JAX or a port optimizer state, in order."""
    out = [np.asarray(x.numpy() if torch.is_tensor(x) else x)
           for x in jax.tree_util.tree_leaves(state, is_leaf=torch.is_tensor)]
    return [a for a in out if np.issubdtype(a.dtype, np.floating)]


def _run_both(jtx, ttx, params, grads):
    jp, tp = _jt(params), _tt(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, js = jtx.update(_jt(g), js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = ttx.update(_tt(g), ts, tp)
        tp = topt.apply_updates(tp, tu)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       atol=ATOL, rtol=RTOL)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=ATOL, rtol=RTOL)
    assert int(ts.step) == int(js.step) == len(grads)
    for a, b in zip(_state_leaves(ts), _state_leaves(js)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    return tp


def _both(name, **kw):
    return getattr(jopt, name)(**kw), getattr(topt, name)(**kw)


class TestFusedAdam:
    @pytest.mark.parametrize("wd", [0.0, 0.1])
    def test_adamw_matches_jax(self, wd):
        params, grads = _problem(0)
        _run_both(*_both("fused_adam", lr=1e-2, weight_decay=wd,
                         adam_w_mode=True), params, grads)

    def test_adam_l2_mode_matches_jax(self):
        params, grads = _problem(1)
        _run_both(*_both("fused_adam", lr=1e-2, weight_decay=0.1,
                         adam_w_mode=False), params, grads)

    def test_no_bias_correction(self):
        params, grads = _problem(2, shapes=((4,),))
        tp = _run_both(*_both("fused_adam", lr=1e-2, bias_correction=False),
                       params, grads[:1])
        g = grads[0]["p0"]
        expect = params["p0"] - 1e-2 * (0.1 * g) / (np.sqrt(0.001 * g * g)
                                                     + 1e-8)
        np.testing.assert_allclose(tp["p0"].numpy(), expect, atol=1e-6)

    def test_amsgrad_rejected(self):
        with pytest.raises(RuntimeError):
            topt.fused_adam(amsgrad=True)

    def test_lr_schedule(self):
        params, grads = _problem(3, shapes=((4,),))
        jtx = jopt.fused_adam(lr=lambda s: 1e-2 / s.astype(jnp.float32))
        ttx = topt.fused_adam(lr=lambda s: 1e-2 / s.float())
        tp = _run_both(jtx, ttx, params, grads)
        assert np.isfinite(tp["p0"].numpy()).all()

    def test_flat_buffer_path_matches_tree_path_and_jax(self):
        params, grads = _problem(4)
        kw = dict(lr=1e-2, weight_decay=0.05)
        _run_both(*_both("fused_adam", use_flat_buffer=True, **kw), params,
                  grads)
        tree = _run_both(*_both("fused_adam", **kw), params, grads)
        flat = _run_both(*_both("fused_adam", use_flat_buffer=True, **kw),
                         params, grads)
        for k in params:
            np.testing.assert_allclose(flat[k].numpy(), tree[k].numpy(),
                                       atol=1e-6, rtol=1e-6)


class TestFusedSGD:
    @pytest.mark.parametrize("kwargs", [
        dict(momentum=0.0, weight_decay=0.0),
        dict(momentum=0.9, weight_decay=0.0),
        dict(momentum=0.9, weight_decay=0.01),
        dict(momentum=0.9, dampening=0.1, weight_decay=0.01),
        dict(momentum=0.9, nesterov=True),
    ])
    def test_matches_jax(self, kwargs):
        params, grads = _problem(5)
        _run_both(*_both("fused_sgd", lr=0.05, **kwargs), params, grads)

    def test_nesterov_validation(self):
        for name in ("fused_sgd", "fused_lars"):
            with pytest.raises(ValueError, match="Nesterov"):
                getattr(topt, name)(momentum=0.0, nesterov=True)


class TestFusedAdagrad:
    @pytest.mark.parametrize("wd, w_mode", [(0.0, False), (0.05, False),
                                            (0.05, True)])
    def test_matches_jax(self, wd, w_mode):
        params, grads = _problem(6)
        _run_both(*_both("fused_adagrad", lr=0.05, weight_decay=wd,
                         adagrad_w_mode=w_mode), params, grads)


class TestFusedNovoGrad:
    def test_one_step_hand_formula(self):
        g0 = np.array([3.0, 4.0], np.float32)   # |g| = 5
        params = {"p0": np.array([1.0, 2.0], np.float32)}
        tp = _run_both(*_both("fused_novograd", lr=0.1, betas=(0.95, 0.98),
                              eps=1e-8, weight_decay=0.0), params,
                       [{"p0": g0}])
        v, bc1, bc2 = 5.0, 1 - 0.95, np.sqrt(1 - 0.98)
        expect = params["p0"] - 0.1 * ((0.05 * g0 / bc1) / (v / bc2 + 1e-8))
        np.testing.assert_allclose(tp["p0"].numpy(), expect, atol=1e-6)

    @pytest.mark.parametrize("kwargs", [
        dict(), dict(weight_decay=0.01), dict(norm_type=0, init_zero=True),
        dict(reg_inside_moment=True, weight_decay=0.01),
        dict(grad_averaging=False, bias_correction=False)])
    def test_matches_jax(self, kwargs):
        params, grads = _problem(8)
        _run_both(*_both("fused_novograd", lr=0.01, **kwargs), params, grads)

    def test_bad_norm_type(self):
        with pytest.raises(RuntimeError, match="l2/inf"):
            topt.fused_novograd(norm_type=1)


class TestFusedLARS:
    def test_one_step_hand_formula(self):
        p0 = np.array([3.0, 4.0], np.float32)        # |p| = 5
        g0 = np.array([0.6, 0.8], np.float32)        # |g| = 1
        tc, wd, lr, mom = 0.001, 0.01, 0.1, 0.9
        tp = _run_both(*_both("fused_lars", lr=lr, momentum=mom,
                              weight_decay=wd, trust_coefficient=tc),
                       {"p0": p0}, [{"p0": g0}])
        slr = lr * tc * 5.0 / (1.0 + 5.0 * wd)
        np.testing.assert_allclose(tp["p0"].numpy(),
                                   p0 - slr * (g0 + wd * p0), atol=1e-7)

    def test_skip_predicate_uses_plain_lr(self):
        p0 = np.array([3.0, 4.0], np.float32)
        g0 = np.array([0.6, 0.8], np.float32)
        tp = _run_both(*_both("fused_lars", lr=0.1, momentum=0.0,
                              trust_coefficient=0.001,
                              skip_predicate=lambda path: True),
                       {"p0": p0}, [{"p0": g0}])
        np.testing.assert_allclose(tp["p0"].numpy(), p0 - 0.1 * g0,
                                   atol=1e-7)

    @pytest.mark.parametrize("kwargs", [
        dict(weight_decay=0.01), dict(weight_decay=0.01, nesterov=True),
        dict(eps=1e-6, dampening=0.0)])
    def test_matches_jax(self, kwargs):
        params, grads = _problem(9)
        _run_both(*_both("fused_lars", lr=0.1, trust_coefficient=0.02,
                         **kwargs), params, grads)


@pytest.mark.parametrize("name, kw", [
    ("fused_adam", dict(lr=1e-2, weight_decay=0.01)),
    ("fused_adam", dict(lr=1e-2, weight_decay=0.01, adam_w_mode=False,
                        norm_telemetry=True)),
    ("fused_lamb", dict(lr=1e-2, weight_decay=0.01)),
    ("fused_lamb", dict(lr=1e-2, weight_decay=0.0, max_grad_norm=0.0,
                        norm_telemetry=True))])
@pytest.mark.parametrize("overflow", [False, True])
def test_fused_apply_is_update_plus_the_step_tail(name, kw, overflow):
    """fused_apply (CPU: the plain version) against update, p + u, the
    overflow select and the fp16 model cast; an fp32 model leaf is the
    new parameter itself; the update norm is the updates' norm."""
    from apex_tpu_torch.optimizers._common import global_norm

    params, grads = _problem(10)
    tx = getattr(topt, name)(**kw)
    p, g = _tt(params), _tt(grads[0])
    state = tx.init(p)
    model_like = {k: v.half() for k, v in p.items()}
    model_like["p1"] = p["p1"]                 # a leaf kept in fp32
    flag = torch.tensor(overflow)
    new_p, new_s, model, usq = tx.fused_apply(
        g, state, p, overflow=flag, model_like=model_like, update_norm=True)
    u, want_s = tx.update(g, state, p)
    want_p = {k: p[k] + u[k] for k in p}
    if overflow:
        want_p, want_s = p, state
    for k in p:
        assert torch.equal(new_p[k], want_p[k])
        assert model[k].dtype == model_like[k].dtype
        assert torch.equal(model[k], want_p[k].to(model_like[k].dtype))
    assert model["p1"] is new_p["p1"]
    for a, b in zip(_state_leaves(new_s), _state_leaves(want_s)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    torch.testing.assert_close(torch.sqrt(usq), global_norm(u), rtol=1e-6,
                               atol=0)
