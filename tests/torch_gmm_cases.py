"""Offsets of the ragged grouped matmul (kernel row 9) for the port's tests:
the LoRA decode and prefill layouts, adversarial windows and the MoE
expert layout (every row in a group, sorted by expert).  numpy only,
so the card-only kernel tests (which import no JAX) share it with the CPU
parity tests."""

import numpy as np


def _offsets(first, counts):
    return np.concatenate([[first], first + np.cumsum(counts)]).astype(
        np.int32)


def offsets_case(name):
    """``(N, G, offsets [G + 1] int32)`` of one named layout."""
    if name == "decode":
        # 32 lanes: 4 no-adapter rows before the window, 28 adapter rows
        # over 20 live groups of a 24-slot pool (2 rows in the first 8)
        counts, live = [], 0
        for g in range(24):
            if g % 6 == 3:
                counts.append(0)
            else:
                counts.append(2 if live < 8 else 1)
                live += 1
        return 32, 24, _offsets(4, counts)
    if name == "prefill":
        # one adapter prompt of 1024 tokens, group 7 of 24
        counts = [0] * 24
        counts[7] = 1024
        return 1024, 24, _offsets(0, counts)
    if name == "empty_groups":
        return 40, 6, _offsets(0, [0, 10, 0, 0, 25, 5])
    if name == "window":
        # offsets[0] > 0 and offsets[-1] < N, N not a tile multiple
        return 77, 5, _offsets(9, [12, 0, 30, 7, 5])
    if name == "one_group":
        return 130, 1, _offsets(3, [125])
    if name == "all_outside":
        return 20, 3, _offsets(20, [0, 0, 0])
    if name == "ragged_300":
        return 300, 4, _offsets(17, [129, 1, 0, 140])
    if name == "many_groups":
        # more than 32 segments: the kernel's tile search carries across
        # warp-wide chunks of the offsets
        counts = np.random.RandomState(70).choice([0, 0, 1, 3, 9, 20], 70)
        return 11 + int(counts.sum()) + 7, 70, _offsets(11, counts)
    if name == "moe":
        # a ragged MoE layer: 4096 token slots over 8 experts, uneven
        return 4096, 8, moe_offsets(4096, 8, seed=6)
    if name == "straddle":
        # segments that start and end inside 128-row tiles, an empty
        # group between them, rows outside on both sides
        return 700, 5, _offsets(20, [100, 150, 0, 200, 130])
    if name == "skewed":
        # one expert holds every row but one (capacity-free routing at
        # init can come close)
        return 1025, 8, _offsets(0, [0, 0, 1024, 0, 0, 1, 0, 0])
    if name == "moe_small":
        # fewer rows than one 64-row tile per expert, one expert empty
        return 50, 4, _offsets(0, [13, 0, 30, 7])
    raise KeyError(name)


def moe_offsets(n, g, seed=0):
    """``[g + 1]`` offsets of ``n`` rows split over ``g`` experts with
    uneven, seeded counts (every row inside the window)."""
    p = np.random.RandomState(seed).dirichlet(np.full(g, 2.0))
    counts = np.random.RandomState(seed + 1).multinomial(n, p)
    return _offsets(0, counts)


ADVERSARIAL = ("empty_groups", "window", "one_group", "all_outside",
               "ragged_300", "many_groups")
MOE = ("moe", "moe_small")
# the 128-row tiles of the tensor-core branches against segment edges
TILE_EDGES = ("straddle", "skewed")
