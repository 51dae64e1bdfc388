"""The port's sampler (apex_tpu_torch.ops.fused_sampling) against the JAX
package's: the counter hash bit for bit, the kernel transcription
_sampling_plain token for token against the JAX Pallas kernel in
interpret mode (same raw uint32 key words), and filter_logits exactly."""

import math

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


ROW_CASES = [
    # (b, V, temps, top_k, top_p, vocab_limit, token-mask holes)
    (2, 1000, [0.9, 1.7], 50, 0.95, 997, False),      # a wide row
    (2, 1000, [1.2, 0.0], None, None, None, False),
    (3, 320, [0.8, 2.0, 1.0], None, 0.9, 310, True),  # top-p alone, holes
    (3, 320, [0.8, 0.0, 1.4], 30, None, None, True),
]


@pytest.mark.parametrize("b, V, temps, top_k, top_p, vocab_limit, holes",
                         ROW_CASES)
@pytest.mark.parametrize("words", [(5, 6), (0xFFFFFFFF, 0x1234)])
def test_sampling_plain_token_exact_vs_jax_kernel_rows(
        monkeypatch, b, V, temps, top_k, top_p, vocab_limit, holes, words):
    """As above at other widths, and with the holes made by a token mask
    ([b, V], True = allowed) instead of the logits."""
    monkeypatch.setenv("APEX_TPU_PALLAS_INTERPRET", "1")
    x = _logits(b, V, seed=V + words[1] % 89)
    mask = None
    if holes:
        mask = np.random.RandomState(V).rand(b, V) > 0.3
        mask[:, 3] = True
    key = jnp.asarray(np.asarray(words, np.uint32))
    want = jfs.fused_sample(jnp.asarray(x), key,
                            temperature=jnp.asarray(temps, jnp.float32),
                            top_k=top_k, top_p=top_p,
                            vocab_limit=vocab_limit,
                            token_mask=None if mask is None
                            else jnp.asarray(mask), backend="kernel")
    got = tfs.fused_sample(torch.from_numpy(x),
                           seed_words=torch.tensor(words, dtype=torch.int64),
                           temperature=torch.tensor(temps), top_k=top_k,
                           top_p=top_p, vocab_limit=vocab_limit,
                           token_mask=None if mask is None
                           else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- K4's launch plan and its candidate pass (no card needed) ----

@pytest.mark.parametrize("filters", [(50, True), (50, False), (0, True),
                                     (0, False)])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("V", [320, 1000, 50304, 152064, 262144])
def test_sample_plan_covers_the_row(V, b, itemsize, filters):
    """Every plan: a cluster of 1-8 CTAs (a power of two) whose slices (a
    multiple of 8 logits, at least 4 KB of logits a CTA where there are
    two or more) cover the row with no empty CTA; slices staged as fp32
    within their budget; with a filter the candidates fill the rest of
    the shared memory, without one there are none; the C entry's byte
    count."""
    top_k, top_p = filters
    p = tfs.sample_plan(b, V, itemsize, top_k, top_p, 132)
    assert p.cluster in (1, 2, 4, 8)
    assert p.slice % 8 == 0 and p.cluster * p.slice >= V
    assert (p.cluster - 1) * p.slice < V
    assert p.cluster == 1 or V * itemsize >= p.cluster * \
        tfs.SAMPLE_MIN_BYTES or p.slice * 4 > tfs.SAMPLE_STAGE_MAX // 2
    stage = p.slice * 4
    assert p.staged == (stage <= tfs.SAMPLE_STAGE_MAX)
    hist = 12 * tfs.SAMPLE_BINS
    if top_k or top_p:
        assert p.cap > 1000
        assert p.smem == (stage if p.staged else 0) + hist + 12 * p.cap
        assert p.smem <= tfs.SAMPLE_SMEM
    else:
        assert p.cap == 0 and p.smem == (stage if p.staged else 0)
    assert p.smem <= 227 * 1024


@pytest.mark.parametrize("b, V, itemsize, cluster", [
    (8, 50304, 4, 8), (8, 50304, 2, 8), (32, 50304, 4, 4), (1, 50304, 4, 8),
    (8, 152064, 4, 8), (8, 262144, 4, 8), (32, 262144, 4, 8),
    (32, 262144, 2, 8), (4, 320, 4, 1), (8, 1000, 4, 1), (8, 4096, 4, 4),
    (8, 4096, 2, 2)])
def test_sample_plan_fills_the_card(b, V, itemsize, cluster):
    """b = 8 rows of GPT-2's vocabulary take 64 SMs, the engine's 32 lanes
    128; a slice past the staging budget doubles the cluster; short rows
    stay in fewer CTAs (at least 4 KB of logits each)."""
    assert tfs.sample_plan(b, V, itemsize, 50, True, 132).cluster == cluster


def test_sample_plan_streams_what_does_not_stage():
    """Past 8 CTAs of 128 KB of fp32 y a row is not staged but read from
    L2 in each pass: no vocabulary is refused."""
    p = tfs.sample_plan(8, 300_000, 2, 50, True, 132)
    assert p.cluster == 8 and not p.staged and p.cap > 10000


_NEG = np.float32(-1e30)
_BINS = tfs.SAMPLE_BINS


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _bucket(y, lo0, sc):
    """csrc/fused_sampling.cu:bucket in fp32 torch arithmetic."""
    t = (y - lo0) * sc
    b = torch.where(t > 0, t, _f32(0.0)).clamp_max(_BINS - 1)
    return b.to(torch.int64)


def _plain_cutoffs(y, k, top_p, greedy):
    """_sampling_plain's cutoffs of one scaled row y (its own steps)."""
    col = torch.arange(y.shape[0])
    kth = theta = None
    if k:
        hi0 = y.amax()
        lo0 = torch.where(y > -5e29, y, hi0).amin()
        kth = tfs._bisect(lo0, hi0, lambda mid: (y >= mid).sum() >= k)
        y = torch.where(y < kth, _f32(-1e30), y)
    if top_p is not None:
        m2 = y.amax()
        live = y > -5e29
        e = torch.where(live, torch.exp(y - m2), _f32(0.0))
        target = _f32(top_p) * e.sum()
        lo0 = torch.where(live, y, m2).amin() - 1.0
        theta = tfs._bisect(
            lo0, m2, lambda mid: torch.where(y > mid, e, _f32(0.0)).sum()
            >= target)
        y = torch.where((y > theta) | (col == greedy), y, _f32(-1e30))
    return kth, theta, y


def _warp_maxima_floor(y, k, cluster):
    """K4's lower bound of the k-th value: in each of ``cluster`` CTAs the
    ceil(k / cluster)-th largest of its 16 warps' maxima (warp w of a CTA
    holds slice elements j with j % 512 // 32 == w), the smallest over
    the CTAs; -inf past 16."""
    V = y.shape[0]
    S = -(-(-(-V // cluster)) // 8) * 8
    m = -(-k // cluster)
    if m > 16:
        return _f32(float("-inf"))
    bounds = []
    for r in range(cluster):
        part = y[r * S:min((r + 1) * S, V)]
        warp = (torch.arange(part.shape[0]) % 512) // 32
        mx = torch.full((16,), float("-inf")).scatter_reduce(
            0, warp, part, "amax")
        bounds.append(torch.sort(mx, descending=True).values[m - 1])
    return torch.stack(bounds).amin()


def _kernel_cutoffs(y, k, top_p, cap, cluster=8):
    """K4's candidate pass and direct cutoffs on one scaled row
    (csrc/fused_sampling.cu, steps 3-5): ``(kth, theta, path)``, path
    "candidates" when the cutoffs came from the candidates alone, else
    "row" (the kernel finishes over the whole row).  Top-k: candidates
    from the bucket of the k-th value up, the buckets spanning the live
    range from a lower bound of the k-th value (the warp maxima's) when
    that is higher than the live minimum.  Top-p alone: the buckets
    between one whose suffix mass (exact in fixed point) reaches the
    target by a 2^-14 margin and one above which it stays below it by that
    margin; the elements above are committed (their mass summed, always
    kept)."""
    live = y > -5e29
    hi0 = y.amax()
    lo0 = y[live].amin() if live.any() else hi0
    floor0 = torch.maximum(_warp_maxima_floor(y, k, cluster), lo0) if k \
        else lo0
    sc = _f32(_BINS) / (hi0 - floor0) if hi0 > floor0 else _f32(0.0)
    if not torch.isfinite(sc):
        sc = _f32(0.0)
    bk = _bucket(y, floor0, sc)
    live = live & (y >= floor0)
    hist = torch.bincount(bk[live], minlength=_BINS)
    jhi, committed = _BINS - 1, _f32(0.0)
    if k:
        hits = torch.nonzero(hist.flip(0).cumsum(0).flip(0) >= k)
    else:
        e_all = torch.where(live, torch.exp(y - hi0), _f32(0.0))
        target = _f32(top_p) * e_all.sum()
        # bucket masses in fixed point (units of 2^-40), summed exactly
        fix = torch.round(e_all.double() * 2.0 ** 40).to(torch.int64)
        bmass = torch.zeros(_BINS, dtype=torch.int64).scatter_add(
            0, bk[live], fix[live])
        suf = bmass.flip(0).cumsum(0).flip(0)
        two40 = _f32(2.0 ** 40)
        hi_thr = math.ceil(float(target * _f32(1 + 2 ** -14) * two40))
        lo_thr = math.floor(float(target * _f32(1 - 2 ** -14) * two40))
        hits = torch.nonzero(suf >= hi_thr)
        above = torch.cat([suf[1:], torch.zeros(1, dtype=torch.int64)])
        low = torch.nonzero(above < lo_thr)
        jhi = int(low.min()) if len(low) else _BINS - 1
        committed = e_all[live & (bk > jhi)].sum()
    jc = int(hits.max()) if len(hits) else 0
    cand = live & (bk >= jc) & (bk <= jhi)
    if int(cand.sum()) > cap:
        return None, None, "row"
    cy = y[cand]
    kth = theta = None
    if k:
        cnt = (cy[None, :] >= cy[:, None]).sum(1)
        tau = cy[cnt >= k].amax() if bool((cnt >= k).any()) \
            else _f32(float("-inf"))
        kth = tfs._bisect(lo0, hi0, lambda mid: mid <= tau)
        if kth < floor0 or int(_bucket(kth, floor0, sc)) < jc:
            return kth, None, "row"
        cy = cy[cy >= kth]
    if top_p is not None:
        ce = torch.exp(cy - hi0)
        if k:
            target = _f32(top_p) * ce.sum()
            lmin = cy.amin() if len(cy) else hi0
        else:
            lmin = lo0
        mass = committed + torch.where(cy[None, :] >= cy[:, None],
                                       ce[None, :], _f32(0.0)).sum(1)
        if target <= 0:
            tau = _f32(float("inf"))
        elif bool((mass >= target).any()):
            tau = cy[mass >= target].amax()
        else:
            tau = _f32(float("-inf"))
        theta = tfs._bisect(lmin - 1.0, hi0, lambda mid: mid < tau)
        nxt = torch.nextafter(theta, _f32(float("inf")))
        if not k and int(_bucket(nxt, floor0, sc)) < jc:
            return kth, theta, "row"
    return kth, theta, "candidates"


def _cutoff_rows():
    """Scaled rows at the candidate pass's edges: ties at the 40th value,
    all-equal rows, -1e30 holes, a vocabulary limit, a nucleus of most of
    the row, and no live element."""
    rng = np.random.RandomState(11)
    rows = []
    x = (rng.randn(2000) * 3).astype(np.float32)
    order = np.argsort(-x)
    x[order[35:48]] = x[order[39]]          # ties around the 40th value
    rows.append(("ties at the k-th", x))
    rows.append(("all equal", np.full(2000, 1.5, np.float32)))
    x = (rng.randn(2000) * 3).astype(np.float32)
    x[::5] = _NEG
    rows.append(("holes", x))
    x = (rng.randn(2000) * 3).astype(np.float32)
    x[1900:] = _NEG                          # n_valid = 1900
    rows.append(("vocab limit", x))
    rows.append(("flat nucleus", (rng.rand(2000) * 0.1).astype(np.float32)))
    x = np.full(2000, _NEG, np.float32)
    x[[3, 700]] = [2.0, 2.0]
    rows.append(("two live", x))
    rows.append(("none live", np.full(2000, _NEG, np.float32)))
    return rows


@pytest.mark.parametrize("cap", [64, 100_000])
@pytest.mark.parametrize("k, top_p", [(40, None), (None, 0.9), (40, 0.8),
                                      (1, 0.5), (1999, None)])
def test_candidate_pass_cutoffs_equal_the_full_row(k, top_p, cap):
    """The candidates' cutoffs are _sampling_plain's, bit for bit, on every
    edge row; where the kernel leaves the candidates for the row pass, it
    finishes with the row's own steps."""
    took = 0
    for name, x in _cutoff_rows():
        y = torch.from_numpy(x)
        greedy = int(torch.argmax(y))
        pk, pt, _ = _plain_cutoffs(y, k, top_p, greedy)
        kk, kt, path = _kernel_cutoffs(y, k, top_p, cap)
        if path == "row":
            continue
        took += 1
        if k:
            assert torch.equal(kk, pk), name
        if top_p is not None:
            assert torch.equal(kt, pt), name
    # with room for every live element only non-converged cutoffs leave
    assert took >= (6 if cap > 2000 else 0)


def test_candidate_pass_takes_the_row_pass_when_it_must():
    """All-equal rows put every element in one bucket: with fewer
    candidate places than elements the kernel takes the row pass."""
    y = torch.full((2000,), 1.5)
    assert _kernel_cutoffs(y, 40, None, 64)[2] == "row"
    assert _kernel_cutoffs(y, 40, None, 4000)[2] == "candidates"


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k, top_p", [(50, 0.95), (None, 0.95), (50, None)])
def test_candidate_draw_tokens_equal_the_plain_sampler(seed, k, top_p):
    """The whole K4 schedule in torch: greedy from the first pass, the
    candidates' cutoffs, the draw over the kept candidates (the row pass
    where the kernel takes it) give _sampling_plain's token on rows of
    logits x 4 at several temperatures, with holes and a vocabulary
    limit."""
    rng = np.random.RandomState(seed)
    b, V, n_valid = 4, 3000, 2990
    x = (rng.randn(b, V) * 4).astype(np.float32)
    x[:, ::7] = _NEG
    temps = torch.tensor([0.6, 1.0, 1.5, 2.0])
    words = (seed + 1, 77 * seed)
    want = tfs._sampling_plain(torch.from_numpy(x), words, temps, k, top_p,
                               n_valid)
    col = torch.arange(V)
    u = tfs._uniform_bits(col[None], torch.arange(b)[:, None], *words)
    g = -torch.log(-torch.log(u))
    for i in range(b):
        xi = torch.from_numpy(x[i])
        valid = col < n_valid
        xm = torch.where(valid, xi, _f32(-1e30))
        greedy = int(torch.where((xm == xm.amax()) & valid, col, V).amin())
        y = torch.where(valid, xi / temps[i].clamp_min(1e-6), _f32(-1e30))
        kk, kt, path = _kernel_cutoffs(y, k, top_p, 4096)
        if path == "row":
            _, _, yf = _plain_cutoffs(y, k, top_p, greedy)
            z = yf + g[i]
        else:
            kept = y > -5e29
            if k:
                kept &= y >= kk
            if top_p is not None:
                kept &= (y > kt) | (col == greedy)
            z = torch.where(kept, y + g[i], _f32(float("-inf")))
        tok = int(torch.where(z == z.amax(), col, V).amin())
        assert tok == int(want[i]), (i, path)


def test_word_buffer_holds_the_two_key_words():
    """K4 reads its key words from a [2] int64 device tensor: Python words
    are written by fills (low 32 bits), a tensor passes as it is; the
    plain path reads a tensor's words too."""
    w = tfs._word_buffer((5, (1 << 32) + 3), torch.device("cpu"))
    assert w.dtype == torch.int64 and w.tolist() == [5, 3]
    t = torch.tensor([7, 0xFFFFFFFF])
    assert tfs._word_buffer(t, torch.device("cpu")).tolist() == [7, 0xFFFFFFFF]
    with pytest.raises(ValueError, match="2 integer words"):
        tfs._word_buffer(torch.tensor([1.0, 2.0]), torch.device("cpu"))
    x = torch.from_numpy(_logits(2, 64, seed=8))
    a = tfs.fused_sample(x, seed_words=(7, 0xFFFFFFFF), temperature=1.0,
                         top_k=5)
    b = tfs.fused_sample(x, seed_words=t, temperature=1.0, top_k=5)
    assert torch.equal(a, b)
