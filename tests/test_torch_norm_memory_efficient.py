"""``memory_efficient=True`` norms of the port (``ops/layer_norm.py``: the
forward saves y, the backward rebuilds x from it in front of K5's plain
version) and the ``normalization`` modules, against the JAX package on
the CPU.

LayerNorm and RMSNorm, with and without the affine parameters and the
bias, with scales of zero (the rebuild's clamp: ``sign(γ)·max(|γ|, eps)``,
``eps`` at zero) and of magnitude below eps: the output and dx, dγ, dβ
against ``jax.vjp`` of JAX's ``memory_efficient=True`` norm.  fp32 within
2e-5 relative to the largest value of each gradient (a rebuilt x carries
the division's rounding), bf16 within 2e-2 (tests/test_torch_layer_norm_
bwd.py's bf16 bound: x rebuilt in bf16 on both sides).  The saved tensors
are y's, not x's.  ``FusedLayerNorm`` / ``FusedRMSNorm`` load a flax
module's variables through ``models/convert.params_from_numpy`` and give
its output and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import normalization as jnorm
from apex_tpu.ops import layer_norm as jln
from apex_tpu_torch import normalization as tnorm
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.ops import layer_norm as tln

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
EPS = 1e-5


def _case(rows, hidden, dtype, affine, bias, zero_scales, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, hidden) * 1.5 + 0.3).astype(np.float32)
    w = (rng.randn(hidden) * 0.5 + 1.0).astype(np.float32) if affine else None
    b = rng.randn(hidden).astype(np.float32) * 0.2 if affine and bias \
        else None
    if affine and zero_scales:
        w[::7] = 0.0
        w[3::11] = 1e-7           # below eps: clamped to eps
    g = rng.randn(rows, hidden).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = [None if a is None else jnp.asarray(a, jdt if a is x or a is g
                                            else jnp.float32)
         for a in (x, w, b, g)]
    t = [None if a is None else torch.from_numpy(a).to(
        tdt if a is x or a is g else torch.float32) for a in (x, w, b, g)]
    return j, t


def _rel_close(got, want, tol, what):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err} > {tol}"


AFFINE = [(True, True, False), (True, True, True), (True, False, False),
          (True, False, True), (False, False, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms,affine,bias,zero_scales", [
    (rms,) + a for rms in (False, True) for a in AFFINE
    if not (rms and a[1])])
def test_memory_efficient_matches_jax(dtype, rms, affine, bias,
                                      zero_scales):
    (jx, jw, jb, jg), (tx, tw, tb, tg) = _case(24, 96, dtype, affine, bias,
                                               zero_scales)
    if rms:
        def jf(x, w):
            return jln.fused_rms_norm(x, w, EPS, memory_efficient=True)
        jy, vjp = jax.vjp(jf, jx, jw)
        jdx, jdw = vjp(jg)
        jdb = None
    else:
        def jf(x, w, b):
            return jln.fused_layer_norm(x, w, b, EPS, memory_efficient=True)
        jy, vjp = jax.vjp(jf, jx, jw, jb)
        jdx, jdw, jdb = vjp(jg)
    tx.requires_grad_(True)
    for p in (tw, tb):
        if p is not None:
            p.requires_grad_(True)
    ty = (tln.fused_rms_norm(tx, tw, EPS, memory_efficient=True) if rms
          else tln.fused_layer_norm(tx, tw, tb, EPS, memory_efficient=True))
    ty.backward(tg)
    tol = TOL[dtype]
    _rel_close(ty, jy, tol, "y")
    _rel_close(tx.grad, jdx, tol, "dx")
    if tw is not None:
        _rel_close(tw.grad, jdw, tol, "dgamma")
    if tb is not None:
        _rel_close(tb.grad, jdb, tol, "dbeta")


@pytest.mark.parametrize("rms", [False, True])
def test_memory_efficient_saves_y_and_agrees_with_the_default(rms):
    (_, _, _, _), (tx, tw, tb, tg) = _case(16, 64, "float32", True, not rms,
                                           False, seed=3)
    packs = []

    def pack(t):
        packs.append(t)
        return t

    grads = []
    for me in (False, True):
        x = tx.clone().requires_grad_(True)
        w = tw.clone().requires_grad_(True)
        packs.clear()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y = (tln.fused_rms_norm(x, w, EPS, memory_efficient=me) if rms
                 else tln.fused_layer_norm(x, w, tb, EPS,
                                           memory_efficient=me))
        assert any(p is y or torch.equal(p, y) for p in packs) == me
        assert any(p is x for p in packs) != me
        y.backward(tg)
        grads.append((x.grad, w.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_rebuild_input_inverts_the_forward():
    (_, _, _, _), (tx, tw, tb, _) = _case(32, 128, "float32", True, True,
                                          False, seed=5)
    y, mu, rs = tln.layer_norm_fwd_stats(tx, tw, tb, EPS)
    x = tln.rebuild_input(y, tw, tb, mu, rs, EPS)
    torch.testing.assert_close(x, tx, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("memory_efficient", [False, True])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_modules_carry_flax_variables(kind, memory_efficient):
    hidden = 48
    rng = np.random.RandomState(7)
    x = rng.randn(3, 5, hidden).astype(np.float32)
    g = rng.randn(3, 5, hidden).astype(np.float32)
    jcls = jnorm.FusedLayerNorm if kind == "layer" else jnorm.FusedRMSNorm
    tcls = tnorm.FusedLayerNorm if kind == "layer" else tnorm.FusedRMSNorm
    jm = jcls(hidden, memory_efficient=memory_efficient)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree.map(
        lambda a: jnp.asarray(rng.randn(*a.shape) * 0.3 + 1.0, a.dtype),
        variables)
    tm = tcls(hidden, memory_efficient=memory_efficient, device="cpu")
    tm.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, variables["params"]), device="cpu"))
    assert all(p.dtype == torch.float32 for p in tm.parameters())

    def jloss(v, xx):
        return jnp.sum(jm.apply(v, xx) * jnp.asarray(g))

    jy = jm.apply(variables, jnp.asarray(x))
    jgv, jgx = jax.grad(jloss, argnums=(0, 1))(variables, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tm(tx)
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jgv["params"][name]),
                                   rtol=1e-4, atol=1e-4)
    assert tnorm.MixedFusedLayerNorm is tnorm.FusedLayerNorm
    with pytest.raises(ValueError, match="normalized_shape"):
        tm(torch.zeros(2, hidden + 1))
