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


# head sizes the kernels take on padded tiles (40 and 80 on the 64- and
# 128-column tiles' second halves, 96 Phi-3-mini's, 80 Phi-2's)
WIDE_HEADS = [40, 80, 96]


@pytest.mark.parametrize("d", WIDE_HEADS)
@pytest.mark.parametrize("dtype, tol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal, padded", [(True, False), (True, True),
                                            (False, True)])
def test_matches_jax_flash_head_dims(d, dtype, tol, causal, padded):
    """The plain forward against the JAX flash_attention (Pallas in
    interpret mode) at head sizes that are not a tile width."""
    b, s = 2, 24
    q, k, v = _qkv(b, s, s, 4, 2, d, seed=d)
    kpm = np.arange(s)[None] >= np.asarray([s, 13])[:, None]
    jkpm = jnp.asarray(kpm) if padded else None
    tkpm = torch.from_numpy(kpm) if padded else None
    want = j_flash(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
                   causal=causal, key_padding_mask=jkpm)
    got = tfa.flash_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        causal=causal, key_padding_mask=tkpm)
    assert got.shape == (b, s, 4, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("d", [129, 256])
def test_head_dims_past_the_tiles_raise(d):
    """Above 128 no tile width takes the head (head_panel raises, naming
    the wide kernels), and the kernel path takes the call all the same:
    the operand checks pass and the call routes to the wide kernels."""
    with pytest.raises(ValueError, match="wide kernels"):
        tfa.head_panel(d)
    tfa.check_head_dim(d)
    q = torch.zeros(1, 4, 2, d)
    kpm, scale = tfa._kernel_operands(q, q, q, None, None)
    assert kpm is None and scale == 1.0 / d ** 0.5 and tfa.wide_head(d)
    with pytest.raises(ValueError, match="at least 1"):
        tfa.check_head_dim(0)


@pytest.mark.parametrize("d, panel", [(8, 32), (32, 32), (40, 64), (64, 64),
                                      (80, 128), (96, 128), (112, 128),
                                      (128, 128), (36, 64), (1, 32)])
def test_head_panel(d, panel):
    """The tile width each head size runs on (sm90::head_panel)."""
    assert tfa.head_panel(d) == panel


def test_pad_head_pads_to_a_multiple_of_8_only_when_needed():
    x = torch.randn(2, 3, 4, 36)
    (p,) = tfa._pad_head(x)
    assert p.shape == (2, 3, 4, 40)
    assert torch.equal(p[..., :36], x) and not p[..., 36:].any()
    y = torch.randn(2, 3, 4, 40)
    assert tfa._pad_head(y)[0].data_ptr() == y.data_ptr()


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
    """Dropout and segment ids run (dropout without a key is no dropout,
    as the JAX wrapper's use_dropout); a single segment_ids array over
    sq != sk raises, as JAX's does."""
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 4, 2, 2, 16))
    base = tfa.flash_attention(q, k, v)
    assert torch.equal(tfa.flash_attention(q, k, v, dropout_p=0.1), base)
    assert torch.equal(tfa.flash_attention(
        q, k, v, segment_ids=torch.zeros(1, 4, dtype=torch.int32)), base)
    with pytest.raises(ValueError, match="sq == sk"):
        tfa.flash_attention(q[:, :3], k, v,
                            segment_ids=torch.zeros(1, 3, dtype=torch.int32))
