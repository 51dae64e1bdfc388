"""Head sizes above 128 (the port's wide flash kernels on the card; the
plain forward and backward on the CPU) against the JAX package's
flash_attention, whose Pallas kernels run in interpret mode: forward and
all three gradients through jax.vjp at head sizes 160, 256 and 320, GQA,
causal, key padding, with and without dropout and segment ids; fp32
inputs, 1e-5 relative to each output's largest element (the tolerance of
tests/test_torch_flash_attention_bwd.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.flash_attention import flash_attention as j_flash
from apex_tpu_torch.ops import flash_attention as tfa

TOL = 1e-5


def _words(key):
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(
        np.int64))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-6))


def _inputs(b, s, n, g, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, n, d).astype(np.float32) * 0.5,
            rng.randn(b, s, g, d).astype(np.float32) * 0.5,
            rng.randn(b, s, g, d).astype(np.float32) * 0.5,
            rng.randn(b, s, n, d).astype(np.float32))


@pytest.mark.parametrize("d", [160, 256, 320])
@pytest.mark.parametrize("feature", [None, "dropout", "segments"])
def test_wide_heads_match_jax(d, feature):
    b, s, n, g = 1, 24, 4, 2
    q, k, v, do = _inputs(b, s, n, g, d, seed=d)
    kpm = np.arange(s)[None] >= np.asarray([19])[:, None]
    key = jax.random.PRNGKey(d)
    jkw = dict(causal=True, key_padding_mask=jnp.asarray(kpm))
    tkw = dict(causal=True, key_padding_mask=torch.from_numpy(kpm))
    if feature == "dropout":
        jkw.update(dropout_p=0.2, dropout_rng=key)
        tkw.update(dropout_p=0.2, dropout_rng=_words(key))
    if feature == "segments":
        seg = np.repeat(np.arange(3), 8)[None].astype(np.int32)
        jkw["segment_ids"] = jnp.asarray(seg)
        tkw["segment_ids"] = torch.from_numpy(seg)
    o, vjp = jax.vjp(lambda *a: j_flash(*a, **jkw),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, **tkw)
    out.backward(torch.from_numpy(do))
    assert tfa.wide_head(d)
    assert _rel(out.detach().numpy(), o) <= TOL
    for t, e, name in zip(leaves, want, ("dq", "dk", "dv")):
        assert _rel(t.grad.numpy(), e) <= TOL, name


def test_head_sizes_route_to_the_wide_kernels():
    """Above 128 every head size takes the wide kernels (no tile width to
    pad to); up to 128 the tiled ones, as before."""
    assert [tfa.wide_head(d) for d in (1, 64, 128, 129, 256, 320, 1000)] \
        == [False] * 3 + [True] * 4
    for d in (129, 320):
        with pytest.raises(ValueError, match="wide kernels"):
            tfa.head_panel(d)
