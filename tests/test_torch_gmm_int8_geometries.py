"""Row 9's int8 slab at the geometries its tensor-core GEMM does not take
(fp32 x, a scale block that is not a multiple of 32, p not a multiple of
16, more than 2048 groups), which the card runs on row 9's CUDA-core int8
branch: the port's grouped_matmul_quantized (its plain version on the
CPU) against the JAX package's, from one slab quantized by each package's
quantize_group_weights (bit for bit equal), on the offsets layouts of
tests/torch_gmm_cases.py.  Both dequantize to fp32 and multiply in fp32 in
another order: 1e-5 relative to the largest output for fp32 x, 1e-2 for
bf16 x (one bf16 rounding of the output)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.grouped_matmul import (
    grouped_matmul_quantized as j_gmmq, quantize_group_weights as j_quant)
from apex_tpu_torch.ops import grouped_matmul as tgm
from torch_gmm_cases import offsets_case


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5),
                                        ("bfloat16", 1e-2)])
@pytest.mark.parametrize("k, p, block", [(96, 40, 48), (64, 24, 32),
                                         (128, 32, 16)])
@pytest.mark.parametrize("case", ["window", "straddle"])
def test_int8_geometries_match_jax(dtype, tol, k, p, block, case):
    n, g, off = offsets_case(case)
    rng = np.random.RandomState(k + p)
    x = rng.randn(n, k).astype(np.float32)
    w = (rng.randn(g, k, p) * 0.1).astype(np.float32)
    jq = j_quant(jnp.asarray(w), block)
    tq = tgm.quantize_group_weights(torch.from_numpy(w), block)
    assert np.array_equal(tq["wire"].numpy(), np.asarray(jq["wire"]))
    assert np.array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    tdt = getattr(torch, dtype)
    takes = tgm.int8_gemm_takes(tdt, k, p, g, block)
    assert not takes or dtype != "float32"
    want = j_gmmq(jnp.asarray(x, getattr(jnp, dtype)), jq["wire"],
                  jq["scale"], jnp.asarray(off))
    got = tgm.grouped_matmul_quantized(torch.from_numpy(x).to(tdt),
                                       tq["wire"], tq["scale"],
                                       torch.from_numpy(off))
    assert got.dtype == tdt and got.shape == (n, p)
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= tol


def test_more_groups_than_the_gemm_takes_match_jax():
    g = tgm.MAX_TILE_GROUPS + 8
    rng = np.random.RandomState(3)
    n, k, p = 300, 32, 16
    off = np.sort(rng.randint(0, n, g + 1)).astype(np.int32)
    x = rng.randn(n, k).astype(np.float32)
    w = (rng.randn(g, k, p) * 0.1).astype(np.float32)
    jq = j_quant(jnp.asarray(w), 32)
    tq = tgm.quantize_group_weights(torch.from_numpy(w), 32)
    assert not tgm.int8_gemm_takes(torch.bfloat16, k, p, g, 32)
    want = j_gmmq(jnp.asarray(x), jq["wire"], jq["scale"], jnp.asarray(off))
    got = tgm.grouped_matmul_quantized(torch.from_numpy(x), tq["wire"],
                                       tq["scale"], torch.from_numpy(off))
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("dtype, k, p, g, kb, takes", [
    (torch.bfloat16, 768, 3072, 8, 128, True),
    (torch.float16, 64, 16, 70, 32, True),
    (torch.float32, 768, 3072, 8, 128, False),
    (torch.bfloat16, 96, 40, 8, 48, False),
    (torch.bfloat16, 64, 40, 8, 32, False),
    (torch.bfloat16, 64, 32, 2049, 32, False)])
def test_int8_route_is_a_function_of_the_geometry(dtype, k, p, g, kb,
                                                  takes):
    assert tgm.int8_gemm_takes(dtype, k, p, g, kb) is takes
