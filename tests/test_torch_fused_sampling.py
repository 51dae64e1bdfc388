"""The port's sampler (apex_tpu_torch.ops.fused_sampling) against the JAX
package's: the counter hash bit for bit, the kernel transcription
_sampling_plain token for token against the JAX Pallas kernel in
interpret mode (same raw uint32 key words), and filter_logits exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import fused_sampling as jfs
from apex_tpu_torch.ops import fused_sampling as tfs


@pytest.mark.parametrize("s0, s1", [(0, 0), (12345, 0xDEADBEEF),
                                    (0xFFFFFFFF, 0x80000001)])
def test_uniform_bits_bit_exact(s0, s1):
    col = np.arange(0, 70000, 7, dtype=np.uint32)[None]
    row = np.arange(5, dtype=np.int32)[:, None]
    want = jfs._uniform_bits(jnp.asarray(col), jnp.asarray(row),
                             jnp.uint32(s0), jnp.uint32(s1))
    got = tfs._uniform_bits(torch.from_numpy(col.astype(np.int64)),
                            torch.from_numpy(row.astype(np.int64)), s0, s1)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def _logits(b, v, seed, holes=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, v) * 3).astype(np.float32)
    x[:, 7] = x[:, 3]                       # a tie
    if holes:
        x[:, ::5] = -1e30                   # masked-out tokens inside the row
    return x


SAMPLE_CASES = [
    # (temps, top_k, top_p, vocab_limit, holes)
    ([1.0, 0.7, 0.0, 1.3], None, None, None, False),
    ([0.8, 0.8, 0.0, 2.0], 5, None, 300, False),
    ([0.8, 1.0, 0.5, 0.0], None, 0.9, 290, False),
    ([0.8, 1.0, 0.5, 3.0], 40, 0.95, 300, True),
]


@pytest.mark.parametrize("temps, top_k, top_p, vocab_limit, holes",
                         SAMPLE_CASES)
@pytest.mark.parametrize("words", [(1, 2), (0x9E3779B9, 77)])
def test_sampling_plain_token_exact_vs_jax_kernel(
        monkeypatch, temps, top_k, top_p, vocab_limit, holes, words):
    monkeypatch.setenv("APEX_TPU_PALLAS_INTERPRET", "1")
    x = _logits(4, 320, seed=sum(words) % 97, holes=holes)
    key = jnp.asarray(np.asarray(words, np.uint32))
    want = jfs.fused_sample(jnp.asarray(x), key,
                            temperature=jnp.asarray(temps, jnp.float32),
                            top_k=top_k, top_p=top_p,
                            vocab_limit=vocab_limit, backend="kernel")
    got = tfs.fused_sample(torch.from_numpy(x), seed_words=words,
                           temperature=torch.tensor(temps), top_k=top_k,
                           top_p=top_p, vocab_limit=vocab_limit)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_k, top_p", [(5, None), (None, 0.9), (7, 0.8),
                                          (None, None)])
def test_filter_logits_exact(top_k, top_p):
    x = _logits(3, 200, seed=4)
    want = jfs.filter_logits(jnp.asarray(x), top_k=top_k, top_p=top_p)
    got = tfs.filter_logits(torch.from_numpy(x), top_k=top_k, top_p=top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_static_temperature_is_masked_argmax():
    x = _logits(3, 100, seed=5)
    x[0, 95] = 1e4                       # beyond the vocab limit
    got = tfs.fused_sample(torch.from_numpy(x), temperature=0.0,
                           vocab_limit=90)
    want = np.argmax(np.where(np.arange(100) < 90, x, -1e30), -1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_reference_keeps_the_filtered_support():
    """The sort-based oracle and the bisection sampler draw from the same
    support: every token either picks lies in the top-k set."""
    x = _logits(2, 64, seed=6)
    allowed = np.argsort(-x, -1)[:, :4]
    gen = torch.Generator().manual_seed(0)
    for i in range(20):
        a = tfs.sample_reference(torch.from_numpy(x), gen, temperature=1.0,
                                 top_k=4)
        b = tfs.fused_sample(torch.from_numpy(x), seed_words=(i, 3 * i),
                             temperature=1.0, top_k=4)
        for row in range(2):
            assert int(a[row]) in allowed[row]
            assert int(b[row]) in allowed[row]


def test_bad_arguments_raise():
    x = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="top_k"):
        tfs.fused_sample(x, temperature=1.0, top_k=0)
    with pytest.raises(ValueError, match="negative"):
        tfs.fused_sample(x, temperature=-1.0)
    with pytest.raises(ValueError, match="backend"):
        tfs.fused_sample(x, temperature=1.0, backend="kernel")
