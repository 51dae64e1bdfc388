"""The port's attention forward (apex_tpu_torch.ops.flash_attention)
against the JAX package's flash_attention, whose Pallas kernel runs in
interpret mode on the CPU: causal, boolean key padding, GQA.  Tolerance
2e-5 at fp32 (tests/test_flash_attention.py), 2e-2 at bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.flash_attention import flash_attention as j_flash
from apex_tpu_torch.ops import flash_attention as tfa


def _qkv(b, sq, sk, n, g, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, n, d).astype(np.float32),
            rng.randn(b, sk, g, d).astype(np.float32),
            rng.randn(b, sk, g, d).astype(np.float32))


CASES = [
    # (b, s, n, g, d, causal, padded)
    (2, 24, 4, 4, 16, True, False),
    (2, 24, 4, 4, 16, True, True),
    (2, 20, 4, 4, 16, False, True),
    (1, 33, 6, 2, 32, True, True),      # GQA, odd length
]


@pytest.mark.parametrize("b, s, n, g, d, causal, padded", CASES)
def test_matches_jax_flash_fp32(b, s, n, g, d, causal, padded):
    q, k, v = _qkv(b, s, s, n, g, d)
    kpm = None
    if padded:
        lens = np.asarray([s - 3 * i for i in range(b)])
        kpm = np.arange(s)[None] >= lens[:, None]
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal,
                   key_padding_mask=None if kpm is None else jnp.asarray(kpm))
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_matches_jax_flash_bf16():
    q, k, v = _qkv(2, 16, 16, 4, 2, 16, seed=1)
    kpm = np.arange(16)[None] >= np.asarray([16, 9])[:, None]
    args_j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    args_t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    want = j_flash(*args_j, causal=True, key_padding_mask=jnp.asarray(kpm))
    got = tfa.flash_attention(*args_t, causal=True,
                              key_padding_mask=torch.from_numpy(kpm))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_additive_and_bool_padding_agree():
    q, k, v = _qkv(2, 12, 12, 2, 2, 16, seed=2)
    kpm = np.arange(12)[None] >= np.asarray([12, 7])[:, None]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    a = tfa.flash_attention(tq, tk, tv, causal=True,
                            key_padding_mask=torch.from_numpy(kpm))
    b = tfa.flash_attention(tq, tk, tv, causal=True,
                            key_padding_mask=tfa._additive_kpm(
                                torch.from_numpy(kpm)))
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_fully_masked_rows_are_zero():
    q, k, v = _qkv(1, 4, 4, 2, 2, 16, seed=3)
    kpm = torch.ones(1, 4, dtype=torch.bool)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              key_padding_mask=kpm)
    assert torch.count_nonzero(out) == 0


def test_training_only_options_raise():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 4, 2, 2, 16))
    with pytest.raises(NotImplementedError, match="dropout"):
        tfa.flash_attention(q, k, v, dropout_p=0.1)
    with pytest.raises(NotImplementedError, match="segment_ids"):
        tfa.flash_attention(q, k, v, segment_ids=torch.zeros(1, 4))
