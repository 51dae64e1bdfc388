"""Kernel row 6 (ragged paged attention) and K3's int8 branch: the port's
plain versions against the JAX Pallas kernels in interpret mode on the
CPU — tail lengths with ``len % block_size`` in {0, 1, block_size - 1},
MHA and GQA, native and int8 pools, sentinel table tails and an empty
lane.  fp32 within 1e-5; bf16 within 2e-2 (the plain version rounds the
probabilities to bf16 before the PV product, the Pallas kernel keeps
them fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import decode_step as jds
from apex_tpu.ops import paged_attention as jpa
from apex_tpu.serving.paged_cache import quantize_kv as j_quantize_kv
from apex_tpu_torch.ops import decode_step as tds
from apex_tpu_torch.ops import paged_attention as tpa

TOL = {np.float32: 1e-5, "bf16": 2e-2}


def _case(seed, nh, g, bs, lens, quant, dh=16, mb=5):
    rng = np.random.RandomState(seed)
    b = len(lens)
    nb = b * mb + 3
    q = rng.randn(b, nh, dh).astype(np.float32)
    kp = rng.randn(nb, bs, g, dh).astype(np.float32)
    vp = rng.randn(nb, bs, g, dh).astype(np.float32)
    tables = rng.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32)
    for i, n in enumerate(lens):
        tables[i, -(-n // bs):] = nb + 2 * i      # unmapped sentinel tail
    out = dict(q=q, kp=kp, vp=vp, tables=tables,
               lens=np.asarray(lens, np.int32))
    if quant:
        for name in ("kp", "vp"):
            w, s = j_quantize_kv(jnp.asarray(out[name]))
            out[name] = np.asarray(w)
            out[name[0] + "s"] = np.asarray(s)
    return out


def _lens(bs):
    # tails with len % bs in {0, 1, bs - 1}, a one-token lane, empty lane
    return [2 * bs, 2 * bs + 1, 3 * bs - 1, 1, 0]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nh, g", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_ragged_paged_attention_matches_jax_kernel(quant, nh, g, bs, dtype):
    c = _case(bs + nh + g, nh, g, bs, _lens(bs), quant)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jq = jnp.asarray(c["q"]).astype(jdt)
    jk, jv = jnp.asarray(c["kp"]), jnp.asarray(c["vp"])
    tq = torch.from_numpy(c["q"]).to(tdt)
    tk, tv = torch.from_numpy(c["kp"]), torch.from_numpy(c["vp"])
    if not quant:
        jk, jv = jk.astype(jdt), jv.astype(jdt)
        tk, tv = tk.to(tdt), tv.to(tdt)
    jsc = tsc = {}
    if quant:
        jsc = dict(k_scale=jnp.asarray(c["ks"]), v_scale=jnp.asarray(c["vs"]))
        tsc = dict(k_scale=torch.from_numpy(c["ks"]),
                   v_scale=torch.from_numpy(c["vs"]))
    want = jpa.ragged_paged_attention(
        jq, jk, jv, jnp.asarray(c["tables"]), jnp.asarray(c["lens"]),
        backend="kernel", **jsc)
    got = tpa.ragged_paged_attention(
        tq, tk, tv, torch.from_numpy(c["tables"]),
        torch.from_numpy(c["lens"]), **tsc)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    # the empty lane gives exact zeros, not NaN
    assert bool((got[-1] == 0).all())


def test_reference_route_equals_default_on_cpu():
    c = _case(0, 4, 2, 4, [5, 8], True)
    args = [torch.from_numpy(c[k]) for k in ("q", "kp", "vp", "tables",
                                             "lens")]
    sc = dict(k_scale=torch.from_numpy(c["ks"]),
              v_scale=torch.from_numpy(c["vs"]))
    assert torch.equal(tpa.ragged_paged_attention(*args, **sc),
                       tpa.ragged_paged_attention(*args, backend="reference",
                                                  **sc))


def test_shape_checks():
    c = _case(1, 4, 2, 4, [5, 8], True)
    args = [torch.from_numpy(c[k]) for k in ("q", "kp", "vp", "tables",
                                             "lens")]
    with pytest.raises(ValueError, match="k_scale"):
        tpa.ragged_paged_attention(*args)
    with pytest.raises(ValueError, match="scales"):
        tpa.ragged_paged_attention(*args, k_scale=torch.ones(2),
                                   v_scale=torch.ones(2))


@pytest.mark.parametrize("nh, g, rope", [(4, 4, False), (4, 2, True)])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_fused_decode_layer_int8_matches_jax_kernel(nh, g, rope, dtype):
    """K3's int8 branch: rope + dequantizing paged attention + projection,
    against the JAX fused kernel (interpret mode) on an int8 pool."""
    bs, dh, h_out = 4, 16, 24
    c = _case(11 + nh, nh, g, bs, _lens(bs), True, dh=dh)
    rng = np.random.RandomState(3)
    w = (rng.randn(nh * dh, h_out) * 0.2).astype(np.float32)
    b = len(c["lens"])
    cos = sin = None
    if rope:
        ang = rng.rand(b, dh // 2).astype(np.float32) * 6
        ang = np.concatenate([ang, ang], -1)
        cos, sin = np.cos(ang), np.sin(ang)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = jds.fused_decode_layer(
        jnp.asarray(c["q"]).astype(jdt), jnp.asarray(c["kp"]),
        jnp.asarray(c["vp"]), jnp.asarray(c["tables"]),
        jnp.asarray(c["lens"]), jnp.asarray(w),
        rope_cos=None if cos is None else jnp.asarray(cos),
        rope_sin=None if sin is None else jnp.asarray(sin),
        backend="kernel", k_scale=jnp.asarray(c["ks"]),
        v_scale=jnp.asarray(c["vs"]))
    got = tds.fused_decode_layer(
        torch.from_numpy(c["q"]).to(tdt), torch.from_numpy(c["kp"]),
        torch.from_numpy(c["vp"]), torch.from_numpy(c["tables"]),
        torch.from_numpy(c["lens"]), torch.from_numpy(w),
        rope_cos=None if cos is None else torch.from_numpy(cos),
        rope_sin=None if sin is None else torch.from_numpy(sin),
        k_scale=torch.from_numpy(c["ks"]), v_scale=torch.from_numpy(c["vs"]))
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
