"""Attention dropout in the port's flash attention (apex_tpu_torch.ops.
flash_attention: the plain forward and backward on the CPU) against the
JAX package's flash_attention, whose Pallas kernels run in interpret mode:

- the counter hash: keep_mask equals JAX's _keep_mask bit for bit over a
  grid of seeds, flat heads, rows and columns, at p = 0, near 1 and
  between; seed_from_key equals _seed_from_rng;
- the mirror of tests/test_flash_attention.py's TestKernelDropout and
  TestDropoutGradCorrectness: the forward and all three gradients against
  jax.vjp with the same key (fp32: 1e-5 relative to each output's largest
  element, the tolerance of tests/test_torch_flash_attention_bwd.py; bf16
  3e-2), under both JAX backward routes, with causal, key padding and
  GQA/MQA; determinism, keep statistics and the 1/(1-p) scale through
  v = I; and the generic-mask route (mha_reference) dropping through the
  same hash."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.flash_attention import (
    _keep_mask as j_keep_mask, _seed_from_rng as j_seed,
    flash_attention as j_flash)
from apex_tpu_torch.ops import flash_attention as tfa

TOL, TOL_BF16 = 1e-5, 3e-2


def _words(key):
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(
        np.int64))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-6))


def _inputs(b, s, n, g, d, seed, sk=None):
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    return (rng.randn(b, s, n, d).astype(np.float32) * 0.5,
            rng.randn(b, sk, g, d).astype(np.float32) * 0.5,
            rng.randn(b, sk, g, d).astype(np.float32) * 0.5,
            rng.randn(b, s, n, d).astype(np.float32))


@pytest.mark.parametrize("key", [0, 7, 2 ** 31 + 5, 123456789])
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0 - 1e-9])
def test_keep_mask_and_seed_are_jax_bit_for_bit(key, p):
    jk = jax.random.PRNGKey(key)
    js = np.asarray(j_seed(jk))
    ts = tfa.seed_from_key(_words(jk))
    assert ts.dtype == torch.int32 and np.array_equal(ts.numpy(), js)
    assert tfa.keep_threshold(p) == min(
        int(round((1.0 - p) * 4294967296.0)), 4294967295)
    for bh, q0, k0 in ((0, 0, 0), (5, 64, 128), (4095, 1 << 20, 77)):
        want = np.asarray(j_keep_mask(jnp.asarray(js)[0], jnp.int32(bh), q0,
                                      k0, (48, 40), 1.0 - p))
        got = tfa.keep_mask(ts, bh, torch.arange(q0, q0 + 48)[:, None],
                            torch.arange(k0, k0 + 40)[None], p)
        assert np.array_equal(got.numpy(), want)


CASES = {
    # name: (b, s, n, g, d, causal, key lengths or None, p)
    "causal": (2, 24, 4, 4, 16, True, None, 0.2),
    "padded": (2, 20, 4, 4, 16, False, [20, 11], 0.3),
    "causal_padded_gqa": (1, 33, 4, 2, 32, True, [25], 0.25),
    "mqa_fully_masked_row": (2, 24, 4, 1, 16, True, [24, 0], 0.4),
}


@pytest.mark.parametrize("mode", ["split", "fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dropout_forward_and_grads_match_jax(monkeypatch, mode, case):
    monkeypatch.setenv("APEX_TPU_FLASH_BWD", mode)
    b, s, n, g, d, causal, lens, p = CASES[case]
    q, k, v, do = _inputs(b, s, n, g, d, seed=len(case))
    kpm = None if lens is None else np.arange(s)[None] >= np.asarray(
        lens)[:, None]
    key = jax.random.PRNGKey(len(case) + 3)
    jkw = dict(causal=causal, dropout_p=p, dropout_rng=key,
               key_padding_mask=None if kpm is None else jnp.asarray(kpm))
    o, vjp = jax.vjp(lambda *a: j_flash(*a, **jkw),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(
        *leaves, causal=causal, dropout_p=p, dropout_rng=_words(key),
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm))
    out.backward(torch.from_numpy(do))
    assert _rel(out.detach().numpy(), o) <= TOL
    for t, e, name in zip(leaves, want, ("dq", "dk", "dv")):
        assert t.grad.shape == e.shape, name
        assert _rel(t.grad.numpy(), e) <= TOL, name


def test_dropout_bf16_matches_jax():
    q, k, v, do = _inputs(2, 32, 4, 2, 16, seed=3)
    key = jax.random.PRNGKey(9)
    args_j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    o, vjp = jax.vjp(lambda *a: j_flash(*a, causal=True, dropout_p=0.1,
                                        dropout_rng=key), *args_j)
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_()
              for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=True, dropout_p=0.1,
                              dropout_rng=_words(key))
    out.backward(torch.from_numpy(do).bfloat16())
    assert out.dtype == torch.bfloat16
    assert _rel(out.float().detach().numpy(),
                np.asarray(o, np.float32)) <= TOL_BF16
    for t, e in zip(leaves, want):
        assert _rel(t.grad.float().numpy(),
                    np.asarray(e, np.float32)) <= TOL_BF16


def test_dropout_deterministic_per_seed():
    q, k, v, _ = map(torch.from_numpy, _inputs(2, 64, 2, 2, 32, seed=10))
    w7, w8 = _words(jax.random.PRNGKey(7)), _words(jax.random.PRNGKey(8))
    a = tfa.flash_attention(q, k, v, dropout_p=0.3, dropout_rng=w7)
    b = tfa.flash_attention(q, k, v, dropout_p=0.3, dropout_rng=w7)
    c = tfa.flash_attention(q, k, v, dropout_p=0.3, dropout_rng=w8)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    # no key, or p = 0: no dropout (the JAX wrapper's use_dropout)
    base = tfa.flash_attention(q, k, v)
    assert torch.equal(tfa.flash_attention(q, k, v, dropout_p=0.3), base)
    assert torch.equal(tfa.flash_attention(q, k, v, dropout_p=0.0,
                                           dropout_rng=w7), base)


def test_dropout_statistics_via_identity_values():
    """With v = I the output rows are the dropped probabilities: kept
    entries scaled by exactly 1/(1-p), the zero fraction within 5 sigma
    of p."""
    s, d, p = 128, 128, 0.4
    q, k, _, _ = _inputs(1, s, 1, 1, d, seed=12)
    v = torch.eye(d)[None, :, None, :]
    q, k = torch.from_numpy(q), torch.from_numpy(k)
    out = tfa.flash_attention(q, k, v, dropout_p=p,
                              dropout_rng=_words(jax.random.PRNGKey(3)))
    dense = tfa.flash_attention(q, k, v).double()
    ratio = out.double() / dense.clamp_min(1e-30)
    kept = ratio > 0.5
    torch.testing.assert_close(ratio[kept], torch.full_like(
        ratio[kept], 1.0 / (1.0 - p)), atol=0, rtol=1e-5)
    frac = 1.0 - kept.double().mean().item()
    assert abs(frac - p) <= 5 * (p * (1 - p) / kept.numel()) ** 0.5


def test_dropout_grads_match_a_dense_composition_with_the_same_mask():
    """TestDropoutGradCorrectness: the gradients against autograd through
    a dense composition that applies keep_mask's bits."""
    b, s, n, d, p = 1, 64, 2, 32, 0.3
    q, k, v, _ = map(torch.from_numpy, _inputs(b, s, n, n, d, seed=22))
    words = _words(jax.random.PRNGKey(5))
    seed = tfa.seed_from_key(words)

    def dense(q_, k_, v_):
        sc = torch.einsum("bsnd,btnd->bnst", q_, k_) / d ** 0.5
        pr = torch.softmax(sc, -1)
        keep = tfa.keep_mask(seed, torch.arange(b * n)[:, None, None],
                             torch.arange(s)[None, :, None],
                             torch.arange(s)[None, None], p)
        pr = torch.where(keep.reshape(b, n, s, s), pr / (1 - p), 0.0)
        return torch.einsum("bnst,btnd->bsnd", pr, v_)

    grads = []
    for fn in (lambda *a: tfa.flash_attention(*a, dropout_p=p,
                                              dropout_rng=words), dense):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, e in zip(*grads):
        torch.testing.assert_close(a, e, atol=1e-4, rtol=1e-4)


def test_dropout_key_padding_and_gqa_parity():
    """The mask keys off the query head: grouped K/V and the same K/V
    repeated give the same output (JAX's test_key_padding_and_dropout_
    parity)."""
    q, k, v, _ = map(torch.from_numpy, _inputs(2, 48, 8, 2, 16, seed=23))
    kpm = torch.arange(48)[None] >= torch.tensor([[40], [48]])
    w = _words(jax.random.PRNGKey(7))
    got = tfa.flash_attention(q, k, v, causal=True, key_padding_mask=kpm,
                              dropout_p=0.3, dropout_rng=w)
    want = tfa.flash_attention(q, k.repeat_interleave(4, 2),
                               v.repeat_interleave(4, 2), causal=True,
                               key_padding_mask=kpm, dropout_p=0.3,
                               dropout_rng=w)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_generic_mask_route_drops_through_the_hash():
    """A generic mask runs mha_reference on every device; its dropout is
    the counter hash of the caller's key, so with an all-open mask it
    equals the flash route's output."""
    q, k, v, _ = map(torch.from_numpy, _inputs(2, 32, 4, 4, 16, seed=24))
    w = _words(jax.random.PRNGKey(11))
    open_mask = torch.zeros(2, 1, 32, 32, dtype=torch.bool)
    a = tfa.flash_attention(q, k, v, mask=open_mask, dropout_p=0.2,
                            dropout_rng=w)
    b = tfa.flash_attention(q, k, v, dropout_p=0.2, dropout_rng=w)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
