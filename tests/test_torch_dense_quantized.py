"""Weight-only int8 matmul (kernel row 10's module) and the quantized
parameter tree: the port against the JAX package on the CPU.

``quantize_weight`` wire and scales bit for bit (round half to even,
all-zero blocks scale 1, NaN poisons its scale); ``dense_quantized``'s
plain version against the JAX Pallas kernel in interpret mode at fp32
within 1e-5 (bf16 within 2e-2), the gradient to x, and
``quantize_params`` / ``dequantize_params`` / ``param_bytes`` leaf for
leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import quantized as jq
from apex_tpu.ops import dense as jd
from apex_tpu_torch.models import quantized as tq
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.ops import dense as td
from torch_port_cases import _params

TOL = {"float32": 1e-5, "bf16": 2e-2}


def _weight(seed, shape):
    rng = np.random.RandomState(seed)
    w = (rng.randn(*shape) * 0.05).astype(np.float32)
    # ties at the rounding midpoint, an all-zero column block
    w[:4, ..., 0] = np.asarray([0.5, -0.5, 1.5, -2.5]).reshape(
        (4,) + (1,) * (w.ndim - 2)) * 0.01
    w.reshape(w.shape[0], -1)[:, 1] = 0.0
    return w


@pytest.mark.parametrize("shape, block", [((256, 96), None),
                                          ((384, 2, 48), None),
                                          ((100, 24), None),
                                          ((96, 40), 32)])
def test_quantize_weight_bitwise(shape, block):
    w = _weight(sum(shape), shape)
    want = jd.quantize_weight(jnp.asarray(w), block)
    got = td.quantize_weight(torch.from_numpy(w), block)
    assert got["wire"].dtype == torch.int8
    np.testing.assert_array_equal(got["wire"].numpy(),
                                  np.asarray(want["wire"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    assert td.pick_quant_block(shape[0], block) == \
        jd.pick_quant_block(shape[0], block)
    np.testing.assert_array_equal(
        td.dequantize_weight(got["wire"], got["scale"]).numpy(),
        np.asarray(jd.dequantize_weight(want["wire"], want["scale"])))


def test_quantize_weight_nan_poisons_its_scale():
    w = _weight(1, (256, 8))
    w[3, 5] = np.nan
    got = td.quantize_weight(torch.from_numpy(w))
    want = jd.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    assert bool(torch.isnan(got["scale"][0, 5]))
    assert not bool(torch.isnan(got["scale"][1]).any())


@pytest.mark.parametrize("m", [1, 13, 130])
@pytest.mark.parametrize("shape", [(256, 96), (384, 2, 48)])
@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_dense_quantized_matches_jax_kernel(m, shape, dtype):
    w = _weight(7, shape)
    x = np.random.RandomState(m).randn(m, shape[0]).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jw = jd.quantize_weight(jnp.asarray(w))
    tw = td.quantize_weight(torch.from_numpy(w))
    want = jd.dense_quantized(jnp.asarray(x).astype(jdt), jw["wire"],
                              jw["scale"], backend="kernel")
    got = td.dense_quantized(torch.from_numpy(x).to(tdt), tw["wire"],
                             tw["scale"])
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(got, td.dense_quantized(
        torch.from_numpy(x).to(tdt), tw["wire"], tw["scale"],
        backend="reference"))


def test_dense_quantized_gradient_reaches_x_only():
    w = _weight(3, (256, 40))
    x = np.random.RandomState(4).randn(5, 256).astype(np.float32)
    jw = jd.quantize_weight(jnp.asarray(w))
    want = jax.grad(lambda a: jnp.sum(jd.dense_quantized(
        a, jw["wire"], jw["scale"], backend="reference") ** 2))(
            jnp.asarray(x))
    tw = td.quantize_weight(torch.from_numpy(w))
    scale = tw["scale"].clone().requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    (td.dense_quantized(tx, tw["wire"], scale) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    assert scale.grad is None


def test_quantized_matmul_routes_plain_and_slab_leaves():
    w = _weight(5, (128, 24))
    x = torch.from_numpy(np.random.RandomState(6).randn(3, 128)
                         .astype(np.float32))
    tw = td.quantize_weight(torch.from_numpy(w))
    assert td.is_quantized(tw) and not td.is_quantized(torch.ones(2))
    assert torch.equal(td.quantized_matmul(x, torch.from_numpy(w)),
                       x @ torch.from_numpy(w))
    assert torch.equal(td.quantized_matmul(x, tw),
                       td.dense_quantized(x, tw["wire"], tw["scale"]))
    with pytest.raises(ValueError, match="contraction"):
        td.dense_quantized(x[:, :64], tw["wire"], tw["scale"])


@pytest.mark.parametrize("name", ["learned_mha_gelu", "rope_gqa_swiglu"])
def test_quantize_params_tree_and_bytes_equal(name):
    jp, _, tp = _params(name)
    jqp, tqp = jq.quantize_params(jp), tq.quantize_params(tp)
    flat_j = jax.tree_util.tree_flatten_with_path(jqp)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tqp))[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        assert str(np.asarray(a).dtype) == str(b.dtype), path
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    assert tq.param_bytes(tqp) == jq.param_bytes(jqp)
    assert tq.param_bytes(tp) == jq.param_bytes(jp)
    assert tq.is_quantized_tree(tqp) and not tq.is_quantized_tree(tp)
    for k, v in tq.dequantize_params(tqp)["layers"].items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(jq.dequantize_params(jqp)["layers"][k]),
            err_msg=k)
    with pytest.raises(ValueError, match="already quantized"):
        tq.quantize_params(tqp)


def test_moe_slabs_quantize_per_layer():
    """Row 9's int8 branch came with the MoE slice: the expert slabs
    quantize per layer as ``quantize_group_weights`` (one scale block of
    32 here: 128 clamped to the in-dim), and ``dequantize_params`` gives
    them back as fp32 slabs within half a scale step."""
    from apex_tpu_torch.ops.grouped_matmul import quantize_group_weights

    cfg = TConfig(num_layers=1, hidden_size=32, num_attention_heads=2,
                  vocab_size=64, max_position_embeddings=16)
    assert cfg.num_experts is None
    w = torch.randn(1, 2, 32, 64, generator=torch.Generator().manual_seed(0))
    q = tq.quantize_params({"layers": {"moe_fc1": w}})["layers"]["moe_fc1"]
    assert tuple(q["wire"].shape) == (1, 2, 32, 64)
    assert tuple(q["scale"].shape) == (1, 2, 1, 64)
    want = quantize_group_weights(w[0])
    assert torch.equal(q["wire"][0], want["wire"])
    assert torch.equal(q["scale"][0], want["scale"])
    deq = tq.dequantize_params({"layers": {"moe_fc1": q}})["layers"]
    err = (deq["moe_fc1"] - w).abs()
    assert bool((err <= q["scale"][:, :, None, 0, :] / 2 + 1e-7).all())


BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("m, k, n, kb, dtype, route", [
    (32, 768, 2304, 128, BF16, "decode"),      # engine decode, 32 lanes
    (1, 768, 768, 128, F16, "decode"),
    (64, 3072, 768, 128, BF16, "decode"),
    (65, 3072, 768, 128, BF16, "tiles"),
    (1024, 768, 3072, 128, BF16, "tiles"),     # a 1024-token prefill
    (4096, 768, 3072, 128, F16, "tiles"),      # the quantized MoE forward
    (32, 768, 2304, 128, F32, "simt"),         # fp32 activations
    (32, 96, 40, 32, BF16, "simt"),            # 40-byte wire rows
    (32, 100, 24, 100, BF16, "simt"),          # kb not a multiple of 32
    (1024, 96, 96, 32, BF16, "tiles")])
def test_dense_route(m, k, n, kb, dtype, route):
    """Row 10's route on the card: the tensor-core kernels take 16-bit x,
    kb % 32 == 0 and rows a TMA map describes; 64 rows or fewer take the
    swapped decode kernel."""
    assert td.dense_route(m, k, n, kb, dtype) == route


@pytest.mark.parametrize("k, n, splits", [
    (768, 2304, 6), (768, 768, 6), (768, 3072, 6), (3072, 768, 8),
    (128, 384, 1), (256, 640, 2), (192, 96, 6)])
def test_decode_splits_at_the_gpt2_sites(k, n, splits):
    """The cluster of the decode route at GPT-2 125M's four matmuls (kb
    128), a single scale block and fewer blocks than a cluster holds."""
    kb = 32 if n == 96 else 128
    assert td.decode_splits(k, n, kb) == splits


def test_decode_splits_bounds():
    """Every cluster holds 1 to 8 CTAs and never more than the scale
    blocks, so each CTA takes at least one whole block; the grid reaches
    ~2 CTAs per SM whenever the blocks allow it."""
    for nkb in range(1, 40):
        for n in range(16, 8192, 272):
            s = td.decode_splits(nkb * 128, n, 128)
            assert 1 <= s <= min(td.MAX_CLUSTER, nkb)
            cols = -(-n // 64)
            if s < min(td.MAX_CLUSTER, nkb):
                assert s * cols >= 264


@pytest.mark.parametrize("row_tiles, n, kb, cols", [
    (8, 768, 128, 64),        # M=1024 proj / fc2: 48 tiles of 128 columns
    (11, 768, 128, 64),       # 66 tiles: 132 of 64 columns, one wave
    (12, 768, 128, 128),      # 72 tiles: 144 of 64 columns, two waves
    (8, 2304, 128, 128),      # M=1024 qkv: 144 tiles, every SM busy
    (32, 768, 128, 128),      # M=4096 fc2: 192 tiles
    (40, 768, 128, 128),      # the MoE fc2 int8 slab (4096 rows, 8 groups)
    (8, 768, 32, 128),        # kb = 32: stages of 32 rows keep 128
    (1, 16, 64, 64)])
def test_int8_column_tile(row_tiles, n, kb, cols):
    """The int8 GEMM narrows its tiles to 64 columns only when twice the
    128-column tiles still fit one wave and the scale block allows
    64-row stages."""
    assert td.int8_column_tile(row_tiles, n, kb) == cols
