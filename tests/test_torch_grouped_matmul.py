"""The port's ragged grouped matmul (plain version of kernel row 9)
against the JAX package's: its XLA reference and its Pallas kernel in
interpret mode, on seeded numpy inputs at the LoRA decode layout and
adversarial offsets (empty groups, a window with ``offsets[0] > 0`` and
``offsets[-1] < N``, one group, every row outside, N above 128), fp32 and
bf16.  Rows outside the window are exactly zero.

The gradient and the int8-slab form are held against the JAX package in
tests/test_torch_grouped_matmul_grad.py.

Tolerances: fp32 1e-5 (the same fp32 products summed in another order);
bf16 outputs one bf16 rounding apart (2**-8 relative, plus 1e-3 absolute
for values near zero).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import grouped_matmul as jgm
from apex_tpu_torch.ops import grouped_matmul as tgm
from apex_tpu_torch.ops import _kernel_utils as ku
from torch_gmm_cases import ADVERSARIAL, TILE_EDGES, offsets_case

CASES = ("decode",) + ADVERSARIAL + TILE_EDGES
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -8, 1e-3)}


def _inputs(case, k, p, dtype, seed=0):
    n, g, off = offsets_case(case)
    rng = np.random.RandomState(seed)
    x = rng.randn(n, k).astype(np.float32)
    w = (rng.randn(g, k, p) * 0.1).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    tw = torch.from_numpy(w).to(tdt)
    return (jx, jw, jnp.asarray(off)), (tx, tw, torch.from_numpy(off)), off


def _np(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k, p", [(32, 8), (8, 48)])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_reference(case, k, p, dtype):
    (jx, jw, joff), (tx, tw, toff), off = _inputs(case, k, p, dtype)
    got = tgm.grouped_matmul(tx, tw, toff)
    want = jgm.grouped_matmul_reference(jx, jw, joff)
    assert str(got.dtype) == f"torch.{want.dtype}"
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)
    assert (_np(got)[:off[0]] == 0).all() and (_np(got)[off[-1]:] == 0).all()


@pytest.mark.parametrize("case, dtype", [
    ("decode", "float32"), ("prefill", "float32"), ("window", "float32"),
    ("empty_groups", "float32"), ("ragged_300", "bfloat16"),
    ("one_group", "bfloat16"), ("all_outside", "bfloat16")])
def test_plain_matches_pallas_kernel_interpret(case, dtype):
    """The Pallas ``_gmm_kernel`` run in interpret mode on the CPU (each
    layout once: interpret mode costs seconds a call)."""
    k, p = (16, 8) if case == "prefill" else (32, 24)
    (jx, jw, joff), (tx, tw, toff), off = _inputs(case, k, p, dtype, 1)
    got = tgm.grouped_matmul(tx, tw, toff)
    want = jgm.grouped_matmul(jx, jw, joff, backend="kernel")
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)
    assert (_np(want)[:off[0]] == 0).all()


@pytest.mark.parametrize("case", CASES + ("prefill",))
def test_group_ids_match_jax(case):
    n, g, off = offsets_case(case)
    want = np.asarray(jgm.group_ids(jnp.asarray(off), n, g))
    got = tgm.group_ids(torch.from_numpy(off), n, g).numpy()
    np.testing.assert_array_equal(got, want)


def test_mixed_dtypes_promote_like_jax():
    (jx, jw, joff), (tx, tw, toff), _ = _inputs("window", 16, 8, "bfloat16")
    got = tgm.grouped_matmul(tx, tw.float(), toff)
    want = jgm.grouped_matmul_reference(jx, jw.astype(jnp.float32), joff)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_empty_rows_and_checks():
    w = torch.zeros(3, 4, 5)
    off = torch.tensor([0, 0, 0, 0], dtype=torch.int32)
    out = tgm.grouped_matmul(torch.zeros(0, 4), w, off)
    assert out.shape == (0, 5) and out.dtype == torch.float32
    with pytest.raises(ValueError):
        tgm.grouped_matmul(torch.zeros(2, 4), w, off[:3])
    with pytest.raises(ValueError):
        tgm.grouped_matmul(torch.zeros(2, 3), w, off)
    with pytest.raises(ValueError):
        tgm.grouped_matmul(torch.zeros(2, 4), w, off, backend="kernel")


def test_gradient_matches_per_group_autograd():
    """The gradient came with the MoE training slice: x and w get theirs
    (here against autograd of the plain per-group products), the offsets
    none, and under no_grad the forward is unchanged."""
    x = torch.randn(4, 4, requires_grad=True)
    w = torch.randn(2, 4, 3, requires_grad=True)
    off = torch.tensor([0, 2, 4], dtype=torch.int32)
    tgm.grouped_matmul(x, w, off).pow(2).sum().backward()
    xr = x.detach().clone().requires_grad_(True)
    wr = w.detach().clone().requires_grad_(True)
    ref = torch.cat([xr[:2] @ wr[0], xr[2:] @ wr[1]])
    ref.pow(2).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad)
    torch.testing.assert_close(w.grad, wr.grad)
    with torch.no_grad():
        assert tgm.grouped_matmul(x, w, off).shape == (4, 3)


@pytest.mark.parametrize("dtype, n, k, p, g, takes", [
    (torch.bfloat16, 4096, 768, 3072, 8, True),     # the MoE fc1
    (torch.float16, 4096, 3072, 768, 8, True),
    (torch.bfloat16, 32, 768, 8, 24, True),         # LoRA A side in bf16
    (torch.bfloat16, 32, 8, 2304, 24, True),        # LoRA B side in bf16
    (torch.bfloat16, 50, 0, 8, 4, True),            # k = 0: zeros, no loads
    (torch.float32, 4096, 768, 3072, 8, False),     # fp32: the CUDA cores
    (torch.bfloat16, 77, 100, 24, 5, False),        # 200-byte rows of x
    (torch.bfloat16, 77, 24, 100, 5, False),        # 200-byte rows of w
    (torch.bfloat16, 77, 64, 64, tgm.MAX_TILE_GROUPS, True),
    (torch.bfloat16, 77, 64, 64, tgm.MAX_TILE_GROUPS + 1, False)])
def test_tensor_core_branch_choice(dtype, n, k, p, g, takes):
    """Which operands the 16-bit tensor-core branch takes: 16-bit types
    whose rows a TMA map can describe (16-byte strides), and a segment
    table that fits in shared memory; the rest keep the fp32 branch."""
    assert tgm._mma_takes(dtype, n, k, p, g) is takes


@pytest.mark.parametrize("shape, itemsize, ok", [
    ((4096, 768), 2, True), ((8, 3072, 768), 2, True),
    ((8, 768, 3072), 1, True), ((77, 100), 2, False), ((77, 24), 1, False),
    ((50, 8), 2, True), ((1, 16), 1, True), ((8, 2 ** 39), 2, False),
    ((5,), 4, True)])
def test_tma_strides_ok(shape, itemsize, ok):
    """A TMA map's conditions on a contiguous tensor: every row stride a
    multiple of 16 bytes below 2**40 (a 1-D tensor has none)."""
    assert ku.tma_strides_ok(shape, itemsize) is ok


@pytest.mark.parametrize("n, p, g, cols", [
    (4096, 768, 8, 256),      # MoE fc2 forward / fc1 dx: 40 x 3 tiles
    (4096, 3072, 8, 128),     # MoE fc1 forward / fc2 dx: 40 x 12 tiles
    (1024, 3072, 4, 128),     # 12 x 12 = 144 tiles of 256: two waves
    (1024, 2816, 4, 256),     # 12 x 11 = 132: exactly one wave
    (32, 2304, 24, 128),      # the LoRA B side in bf16: 25 x 9 = 225
    (50, 8, 4, 256),
    (16384, 256, 1, 256)])    # 129 row tiles of one column tile
def test_mma_column_tile(n, p, g, cols):
    """The 16-bit GEMM takes 256-column tiles only when they fit in one
    wave of the 132 persistent CTAs (no tail to lose), else 128."""
    assert tgm.mma_column_tile(n, p, g) == cols


@pytest.mark.parametrize("n, k, p, g, plan", [
    (32, 768, 8, 24, (4, 1)),      # LoRA decode, A side of qkv/proj/fc1
    (32, 3072, 8, 24, (4, 4)),     # decode fc2 A: 34 CTAs, 768 k rows each
    (32, 8, 2304, 24, (4, 1)),     # decode B sides: 306 CTAs fill the card
    (32, 8, 768, 24, (4, 1)),
    (1024, 768, 8, 24, (4, 1)),    # adapter prefill A: 282 row tiles
    (1024, 3072, 8, 24, (4, 1)),
    (1024, 8, 3072, 24, (16, 1)),  # prefill B: short k, 16-row tiles
    (77, 100, 24, 5, (4, 1)),
    (40, 0, 5, 6, (4, 1)),         # k = 0
    (16, 100000, 4, 1, (4, 8)),    # a long contraction: the largest cluster
    (8192, 8, 64, 2, (16, 1))])
def test_fp32_tiles(n, k, p, g, plan):
    """Row 9's fp32 branch: 4-row tiles unless a short contraction meets
    16 or more rows per segment; a cluster splits the contraction only
    when the tiles leave SMs idle, each CTA keeping 768 k rows or more,
    at most 8 CTAs."""
    assert tgm.fp32_tiles(n, k, p, g) == plan
