"""Ring and Ulysses attention of the port against the JAX package's
(``apex_tpu/parallel/ring_attention.py``, ``apex_tpu/parallel/ulysses.py``).

- The ring's chunk plain versions (``_chunk_fwd_ref``, ``_chunk_bwd_ref``:
  what a CPU tensor runs in place of the fp32-output branches of K2, K6
  and K7) against JAX's ``_fwd_pallas`` / ``_bwd_pallas`` in interpret
  mode at the ring's call shapes: bf16 inputs, ``out_dtype=float32``,
  with and without ``gqa`` (tests/test_ring_attention.py:154-189).
- ``ring_attention`` and ``ulysses_attention`` on one spawned gloo world
  of 4 ranks against JAX's under ``shard_map`` on ``create_mesh(sp=4)``:
  the output and the gradients of ``sum(out · dout)``, causal and full,
  an unaligned local length (12 rows a rank) and grouped K/V.  fp32, so
  rtol/atol 2e-5 on the output and 1e-4 on the gradients (JAX's own ring
  tests' tolerances).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.ops.flash_attention import _bwd_pallas, _fwd_pallas
from apex_tpu.parallel.mesh import create_mesh
from apex_tpu.parallel.ring_attention import ring_attention as j_ring
from apex_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from apex_tpu_torch.parallel.ring_attention import (
    _chunk_bwd_ref, _chunk_fwd_ref)
from torch_dist_cases import run_world
from torch_train_cases import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SP = 4
# name: (b, s, n, g, d, causal, mode)
CASES = {
    "ring_causal": (2, 64, 4, 4, 16, True, "ring"),
    "ring_full": (2, 64, 4, 4, 16, False, "ring"),
    "ring_unaligned": (1, 48, 2, 2, 16, True, "ring"),
    "ring_gqa": (2, 64, 4, 2, 16, True, "ring"),
    "ulysses_causal": (2, 64, 4, 4, 16, True, "ulysses"),
    "ulysses_full": (1, 48, 4, 4, 16, False, "ulysses"),
}
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _case_data(b, s, n, g, d, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, s, n, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, s, g, d) * 0.5).astype(np.float32)
    v = (rng.randn(b, s, g, d) * 0.5).astype(np.float32)
    dout = rng.randn(b, s, n, d).astype(np.float32)
    return q, k, v, dout


def _jax_reference(q, k, v, dout, causal, mode):
    mesh = create_mesh(sp=SP)
    fn = j_ulysses if mode == "ulysses" else j_ring

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P(None, "sp"),) * 3,
                       out_specs=P(None, "sp"))
    def f(q, k, v):
        return fn(q, k, v, "sp", causal=causal)

    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    dq, dk, dv = vjp(jnp.asarray(dout))
    return {key: np.asarray(x) for key, x in
            (("o", o), ("dq", dq), ("dk", dk), ("dv", dv))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, data = {}, {}
    for i, (name, (b, s, n, g, d, causal, mode)) in enumerate(CASES.items()):
        q, k, v, dout = _case_data(b, s, n, g, d, seed=i)
        data[name] = (q, k, v, dout, causal, mode)
        cases[name] = dict(q=q, k=k, v=v, dout=dout, causal=causal,
                           mode=mode)
    got = run_world("ring", SP, {"sp": SP, "cases": cases},
                    tmp_path_factory.mktemp("ring"))
    return got, data


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_under_shard_map(world, name):
    got, data = world
    want = _jax_reference(*data[name])
    for r in range(SP):     # every rank gathered the whole sequence
        res = got[r][name]
        np.testing.assert_allclose(res["o"], want["o"], **FWD_TOL,
                                   err_msg=f"{name} o, rank {r}")
        for key in ("dq", "dk", "dv"):
            np.testing.assert_allclose(res[key], want[key], **GRAD_TOL,
                                       err_msg=f"{name} {key}, rank {r}")


@pytest.mark.parametrize("gqa", [None, (2, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_chunk_plain_versions_match_the_pallas_calls(causal, gqa):
    """bf16 chunk operands, fp32 outputs: the port's plain chunk forward
    against ``_fwd_pallas(..., out_dtype=float32)`` and its backward, from
    the caller's lse and delta, against ``_bwd_pallas``, in interpret mode
    (JAX's ``[b·h, s, d]`` layout, ``b = 1``).  The Pallas forward rounds
    p to bf16 for the PV product and the plain version keeps it fp32: o
    within 5e-3 (measured 1.2e-3); lse and the gradients, fp32 on both
    sides, within 1e-5."""
    rng = np.random.RandomState(3)
    n, s, d = 2, 128, 32
    g = 1 if gqa else n
    q3 = jnp.asarray(rng.randn(n, s, d) * 0.5, jnp.bfloat16)
    k3 = jnp.asarray(rng.randn(g, s, d) * 0.5, jnp.bfloat16)
    v3 = jnp.asarray(rng.randn(g, s, d) * 0.5, jnp.bfloat16)
    do3 = jnp.asarray(rng.randn(n, s, d), jnp.bfloat16)
    scale = 0.125
    o, lse = _fwd_pallas(q3, k3, v3, None, None, None, scale, causal, s,
                         128, 128, 0.0, True, out_dtype=jnp.float32, gqa=gqa)
    delta = jnp.sum(o.astype(jnp.bfloat16).astype(jnp.float32)
                    * do3.astype(jnp.float32), axis=-1)
    dq, dk, dv = _bwd_pallas(q3, k3, v3, do3, lse, delta, None, None, None,
                             scale, causal, s, s, 128, 128, 0.0, True,
                             out_dtype=jnp.float32, gqa=gqa)
    assert o.dtype == jnp.float32 and dq.dtype == jnp.float32

    def bsnd(x):    # [h, s, d] of batch 1 -> [1, s, h, d]
        return torch.from_numpy(
            np.array(x.astype(jnp.float32))).permute(1, 0, 2)[None]

    tq, tk, tv, tdo = (bsnd(x).to(torch.bfloat16)
                       for x in (q3, k3, v3, do3))
    t_o, t_lse = _chunk_fwd_ref(tq, tk, tv, scale, causal)
    assert t_o.dtype == torch.float32
    np.testing.assert_allclose(t_o[0].permute(1, 0, 2).numpy(),
                               np.asarray(o), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(lse), rtol=1e-5,
                               atol=1e-5)
    # the backward from JAX's own lse and delta: the ring passes the
    # global ones to every chunk
    t_dq, t_dk, t_dv = _chunk_bwd_ref(
        tq, tk, tv, tdo, torch.from_numpy(np.array(lse)),
        torch.from_numpy(np.array(delta)), scale, causal)
    for got, want in ((t_dq, dq), (t_dk, dk), (t_dv, dv)):
        assert got.dtype == torch.float32
        assert got[0].permute(1, 0, 2).shape == want.shape
        np.testing.assert_allclose(got[0].permute(1, 0, 2).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
