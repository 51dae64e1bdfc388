"""The port's fused decode layer (apex_tpu_torch.ops.decode_step) against
the JAX package's fused_decode_layer: its Pallas kernel in interpret mode
and its reference composition.  MHA, GQA and MQA, wide groups (12 query
heads on one kv group at dh 64, 16 at dh 128), rope and none, ragged
lengths with unmapped table tails, lengths at the split-key kernel's
chunk edges and an empty lane whose table holds only sentinels.
Tolerance 2e-5 at fp32 (tests/test_decode_fused.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import decode_step as jds
from apex_tpu_torch.ops import decode_step as tds
from apex_tpu_torch.ops import paged_attention as tpa

TOL = 2e-5


def _case(b, nh, g, dh, bs, mb, lens, rope, seed=0):
    rng = np.random.RandomState(seed)
    nb = b * mb + 2
    q = rng.randn(b, nh, dh).astype(np.float32)
    kp = rng.randn(nb, bs, g, dh).astype(np.float32)
    vp = rng.randn(nb, bs, g, dh).astype(np.float32)
    tables = rng.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32)
    for i, n in enumerate(lens):          # unmapped sentinels past the length
        tables[i, -(-n // bs):] = nb + 3
    lengths = np.asarray(lens, np.int32)
    w = (rng.randn(nh * dh, 48) * 0.05).astype(np.float32)
    cos = sin = None
    if rope:
        ang = rng.rand(b, dh // 2).astype(np.float32) * 6.0
        ang = np.concatenate([ang, ang], -1)
        cos, sin = np.cos(ang), np.sin(ang)
    return q, kp, vp, tables, lengths, w, cos, sin


def _edge_case(nh, g, dh, rope, bs=16, mb=12):
    """Five lanes at the card's plan's chunk - 1, chunk, chunk + 1, one over
    three chunks and an empty (all-sentinel) lane, fp32 operands."""
    chunk = tpa.paged_plan(5, g, nh // g, dh, bs * mb, 4, 132).chunk
    lens = [chunk - 1, chunk, chunk + 1, min(3 * chunk - 5, bs * mb), 0]
    return (5, nh, g, dh, bs, mb, lens, rope)


CASES = [
    # (b, nh, g, dh, bs, mb, lens, rope)
    (3, 4, 4, 16, 4, 5, [1, 9, 20], False),
    (3, 4, 4, 16, 4, 5, [3, 16, 7], True),
    (2, 8, 2, 16, 8, 3, [5, 24], True),       # GQA rep 4
    (2, 6, 1, 32, 4, 4, [13, 2], False),       # MQA
    _edge_case(12, 1, 64, True),               # MQA rep 12 (gpt_125m's)
    _edge_case(16, 1, 128, False),             # rep 16, rep * dh 2048
]


def _run_both(case, monkeypatch, backend):
    q, kp, vp, tables, lengths, w, cos, sin = _case(*case)
    monkeypatch.setenv("APEX_TPU_PALLAS_INTERPRET", "1")
    j = jds.fused_decode_layer(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(w),
        rope_cos=None if cos is None else jnp.asarray(cos),
        rope_sin=None if sin is None else jnp.asarray(sin), backend=backend)
    t = tds.fused_decode_layer(
        *map(torch.from_numpy, (q, kp, vp, tables, lengths, w)),
        rope_cos=None if cos is None else torch.from_numpy(cos),
        rope_sin=None if sin is None else torch.from_numpy(sin))
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("case", CASES)
def test_matches_jax_kernel_interpret(case, monkeypatch):
    want, got = _run_both(case, monkeypatch, "kernel")
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_matches_jax_reference(case, monkeypatch):
    want, got = _run_both(case, monkeypatch, "reference")
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_bf16_dtype_edges_match_jax_reference():
    """bf16: the roped query and the context round to the compute dtype
    and W is cast to it before the product, as in the JAX reference."""
    q, kp, vp, tables, lengths, w, cos, sin = _case(
        2, 4, 4, 16, 4, 4, [6, 15], True, seed=5)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)]
    want = jds.decode_layer_reference(
        *jb, jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(w),
        rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin))
    got = tds.fused_decode_layer(
        *tb, torch.from_numpy(tables), torch.from_numpy(lengths),
        torch.from_numpy(w), rope_cos=torch.from_numpy(cos),
        rope_sin=torch.from_numpy(sin))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_shape_and_option_checks():
    q, kp, vp, tables, lengths, w, _, _ = _case(2, 4, 4, 16, 4, 3, [3, 5],
                                                False)
    args = list(map(torch.from_numpy, (q, kp, vp, tables, lengths, w)))
    with pytest.raises(ValueError, match="w_proj"):
        tds.fused_decode_layer(*args[:5], args[5][:-1])
    with pytest.raises(ValueError, match="together"):
        tds.fused_decode_layer(*args, rope_cos=torch.ones(2, 16))
    # scales belong to int8 pools only (the int8 branch is ported)
    with pytest.raises(ValueError, match="int8"):
        tds.fused_decode_layer(*args, k_scale=torch.ones(1),
                               v_scale=torch.ones(1))
