"""The port's plain-PyTorch pieces of the decode path against the JAX
package's: rotary embeddings (cached and ragged layouts, full and partial
rotation), the paged-attention oracle, and the paged pool allocation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.transformer_lm import rope_cos_sin as j_rope_tables
from apex_tpu.ops import paged_attention as jpa
from apex_tpu.ops import rope as jrope
from apex_tpu_torch.models.config import TransformerConfig
from apex_tpu_torch.models.transformer_lm import rope_cos_sin
from apex_tpu_torch.ops import paged_attention as tpa
from apex_tpu_torch.ops import rope as trope
from apex_tpu_torch.serving.paged_cache import blocks_for, init_paged_pool


@pytest.mark.parametrize("d2", [16, 8])        # full and partial rotation
def test_rope_cached_and_ragged_match_jax(d2):
    rng = np.random.RandomState(0)
    t = rng.randn(3, 5, 4, 16).astype(np.float32)
    jcos, jsin = j_rope_tables(12, d2)
    cos, sin = rope_cos_sin(12, d2)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    want = jrope.fused_apply_rotary_pos_emb_cached(
        jnp.asarray(t), jcos[None, :5, None, :], jsin[None, :5, None, :])
    got = trope.fused_apply_rotary_pos_emb_cached(
        torch.from_numpy(t), cos[None, :5, None, :], sin[None, :5, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    pos = np.asarray([0, 4, 9], np.int32)          # 9 + 4 clamps to row 11
    want = jrope.fused_apply_rotary_pos_emb_ragged(jnp.asarray(t), jcos, jsin,
                                                   jnp.asarray(pos))
    got = trope.fused_apply_rotary_pos_emb_ragged(torch.from_numpy(t), cos,
                                                  sin, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("g", [4, 2, 1])
def test_paged_attention_reference_matches_jax(g):
    rng = np.random.RandomState(1)
    b, nh, dh, bs, mb = 3, 4, 16, 4, 4
    nb = b * mb + 1
    q = rng.randn(b, nh, dh).astype(np.float32)
    kp = rng.randn(nb, bs, g, dh).astype(np.float32)
    vp = rng.randn(nb, bs, g, dh).astype(np.float32)
    tables = rng.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32)
    tables[0, 2:] = nb + 7                          # unmapped tail
    lens = np.asarray([6, 16, 1], np.int32)
    want = jpa.paged_attention_reference(*map(jnp.asarray, (
        q, kp, vp, tables, lens)))
    got = tpa.paged_attention_reference(*map(torch.from_numpy, (
        q, kp, vp, tables, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_paged_pool_shapes_and_int8_wire():
    cfg = TransformerConfig(num_layers=2, hidden_size=64,
                            num_attention_heads=4, num_query_groups=2)
    pool = init_paged_pool(cfg, 5, 8, device="cpu")
    assert pool["k"].shape == (2, 5, 8, 2, 16)
    assert pool["k"].dtype == torch.bfloat16
    assert blocks_for(17, 8) == 3 and blocks_for(0, 8) == 0
    q8 = init_paged_pool(cfg, 5, 8, cache_wire="int8", device="cpu")
    assert q8["k"].dtype == torch.int8 and q8["k"].shape == (2, 5, 8, 2, 16)
    assert q8["k_scale"].shape == (2, 5, 8, 2)
    assert bool((q8["v_scale"] == 1).all())
    with pytest.raises(ValueError, match="cache_wire"):
        init_paged_pool(cfg, 5, 8, cache_wire="fp8", device="cpu")
