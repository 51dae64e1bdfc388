"""The port's hand-written CUDA kernels (K1–K7, K3's int8 branch, row 5
short-key flash backward, row 6 ragged paged attention, row 9 ragged
grouped matmul — its fp32, 16-bit, transposed and int8 branches — row 10
int8-weight matmul, row 11 scaled masked softmax)
against their plain PyTorch versions, on the card.  Marked
``cuda``: they skip where there is no CUDA device.  This file imports no
JAX, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import pytest
import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.ops import decode_step as tds
from apex_tpu_torch.ops import flash_attention as tfa
from apex_tpu_torch.ops import fused_sampling as tfs
from apex_tpu_torch.ops import layer_norm as tln
from apex_tpu_torch.ops import softmax as tsm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on the card)")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("hidden", [768, 100, 4096])   # register / scalar
def test_k1_layer_norm(dev, dtype, tol, rms, hidden):
    g = _gen(0)
    x = (torch.randn(300, hidden, device=dev, generator=g) * 2).to(dtype)
    w = torch.randn(hidden, device=dev, generator=g)
    b = None if rms else torch.randn(hidden, device=dev, generator=g)
    before = tln.LN_FWD.launches
    y, mu, rs = tln.layer_norm_fwd_stats(x, w, b, rms=rms)
    ry, rmu, rrs = tln.layer_norm_fwd_stats(x, w, b, rms=rms,
                                            backend="reference")
    torch.cuda.synchronize()
    assert tln.LN_FWD.launches == before + 1
    torch.testing.assert_close(y.float(), ry.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(mu, rmu, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rs, rrs, atol=1e-5, rtol=1e-5)


def _k1_check(x, w, b, rms, tol):
    """One launch of K1 on x, held against the plain version: y within
    tol, mu and rstd within 1e-5."""
    before = tln.LN_FWD.launches
    y, mu, rs = tln.layer_norm_fwd_stats(x, w, b, rms=rms)
    ry, rmu, rrs = tln.layer_norm_fwd_stats(x, w, b, rms=rms,
                                            backend="reference")
    torch.cuda.synchronize()
    assert tln.LN_FWD.launches == before + 1
    torch.testing.assert_close(y.float(), ry.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(mu, rmu, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rs, rrs, atol=1e-5, rtol=1e-5)
    return y, mu, rs


# (hidden, dtype, tolerance): the main paths' widths, the widest
# register row, fp32, and an odd width (the scalar kernel)
_K1_WIDTHS = {"bf16 h768": (768, torch.bfloat16, 2e-2),
              "bf16 h1024": (1024, torch.bfloat16, 2e-2),
              "bf16 h2048": (2048, torch.bfloat16, 2e-2),
              "fp32 h1024": (1024, torch.float32, 1e-5),
              "bf16 h770 odd": (770, torch.bfloat16, 2e-2)}


@pytest.mark.parametrize("mode", ["affine", "no affine", "rms"])
@pytest.mark.parametrize("width", sorted(_K1_WIDTHS))
@pytest.mark.parametrize("rows", [1, 8, 32, 33, 4096, 16384])
def test_k1_rows_and_widths(dev, rows, width, mode):
    """K1 at decode's few rows (one 1-warp CTA a row), just past them and
    at the training steps' many rows (persistent warps, next row in
    flight), at every register width and on the scalar kernel; with
    gamma and beta, with neither, and as RMSNorm."""
    hidden, dtype, tol = _K1_WIDTHS[width]
    g = _gen(30)
    x = (torch.randn(rows, hidden, device=dev, generator=g) * 2
         + 0.5).to(dtype)
    w = b = None
    if mode != "no affine":
        w = torch.randn(hidden, device=dev, generator=g)
    if mode == "affine":
        b = torch.randn(hidden, device=dev, generator=g)
    plan = tln.ln_plan(rows, hidden, x.element_size(), True,
                       torch.cuda.get_device_properties(dev)
                       .multi_processor_count)
    assert (plan.vectors == 0) == width.endswith("odd")
    _k1_check(x, w, b, mode == "rms", tol)


@pytest.mark.parametrize("rows, hidden", [(8, 768), (4096, 768),
                                          (16384, 768), (4096, 1024)])
def test_k1_repeats_bitwise_and_captures(dev, rows, hidden):
    """Twenty launches give the same bits (one writer per element, a
    fixed order of addition), and a launch captured in a CUDA graph
    replays on new inputs as the eager call does."""
    g = _gen(31)
    x = torch.randn(rows, hidden, device=dev, generator=g).bfloat16()
    w = torch.randn(hidden, device=dev, generator=g)
    b = torch.randn(hidden, device=dev, generator=g)
    first = tln.layer_norm_fwd_stats(x, w, b)
    for _ in range(20):
        again = tln.layer_norm_fwd_stats(x, w, b)
        assert all(torch.equal(a, e) for a, e in zip(again, first))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tln.layer_norm_fwd_stats(x, w, b)
    x.copy_(torch.randn(rows, hidden, device=dev, generator=g))
    graph.replay()
    eager = tln.layer_norm_fwd_stats(x, w, b)
    torch.cuda.synchronize()
    assert all(torch.equal(a, e) for a, e in zip(captured, eager))
    assert not torch.equal(captured[0], first[0])


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2),
                                        (torch.float16, 2e-3)])
@pytest.mark.parametrize("n, g, causal, padded, d", [
    (4, 4, True, False, 64), (4, 4, True, True, 64), (4, 4, False, True, 64),
    (12, 4, True, True, 64), (4, 2, True, True, 128), (4, 4, True, True, 32),
    (8, 1, True, True, 64), (4, 1, False, True, 128),
    (8, 2, False, False, 32), (4, 2, True, True, 40), (4, 4, True, True, 80),
    (4, 1, False, True, 96), (8, 2, True, False, 112)])
@pytest.mark.parametrize("sq, sk", [(130, 130), (1030, 1030), (130, 300),
                                    (300, 130)])
def test_k2_flash_attention(dev, dtype, tol, n, g, causal, padded, d, sq,
                            sk):
    """K2 against mha_reference: tails past a 128-row tile (130, 1030),
    sq != sk, MQA and GQA, every tile width and head sizes between them
    (40, 80, 96, 112: the tile's columns past d zero-filled, o clipped at
    d); when padded, batch row 2 is fully masked (o = 0, lse = -1e30)."""
    gen = _gen(1)
    b = 3
    q = torch.randn(b, sq, n, d, device=dev, generator=gen).to(dtype)
    k = torch.randn(b, sk, g, d, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, sk, g, d, device=dev, generator=gen).to(dtype)
    kpm = None
    if padded:
        lens = torch.tensor([sk, 77, 0], device=dev)
        kpm = torch.arange(sk, device=dev)[None] >= lens[:, None]
    before = tfa.FLASH_FWD.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                     key_padding_mask=kpm)
    ref, ref_lse = tfa.flash_attention_fwd_ref(q, k, v, causal=causal,
                                               key_padding_mask=kpm)
    torch.cuda.synchronize()
    assert tfa.FLASH_FWD.launches == before + 1
    torch.testing.assert_close(o.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.isfinite(lse).all()
    live = ref_lse > -1e29
    assert torch.equal(lse > -1e29, live)
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3,
                               rtol=1e-4)
    if padded:
        assert torch.count_nonzero(o[2]) == 0
        assert bool((lse.reshape(b, n, sq)[2] == -1e30).all())


# (nh, g, dh): MHA and GQA at GPT-2's dh and at dh 128 (every kernel
# variant: 1, 4 or 16 heads a CTA, 64 or 128 dims), and the wide groups
# the split-key kernel takes since its redesign: MQA on 12 heads
# (gpt_125m's), 16 query heads a group at dh 128, 32 (rep * dh = 4096)
PAGED_GEOMETRIES = [(12, 12, 64), (12, 4, 64), (8, 1, 64), (12, 1, 64),
                    (8, 8, 128), (8, 2, 128), (16, 1, 128), (32, 1, 128)]


def _decode_operands(dev, dtype, nh, g, dh, seed, bs=16, mb=12, quant=False,
                     w_dtype=torch.float32, pool_dtype=None):
    """q, pools, tables with sentinel tails (>= num_blocks) sized to each
    lane's length, w_proj [nh*dh, 256] and rope rows over the whole head.
    The lengths sit at every edge (k*step - 1, k*step, k*step + 1) of the
    plan's chunk granularity (step = warps x warp tile, so at every chunk
    edge whatever the split count), one token, the full reach, and an
    empty lane, last, whose table holds only sentinels.  A float pool is
    in ``pool_dtype`` (default: the compute dtype)."""
    from apex_tpu_torch.ops import paged_attention as tpa

    gen = _gen(seed)
    reach = mb * bs
    pool_dtype = dtype if pool_dtype is None else pool_dtype
    isz = 1 if quant else torch.empty((), dtype=pool_dtype).element_size()
    step = tpa.WARPS * tpa.paged_plan(1, g, nh // g, dh, reach, isz,
                                      132).tile
    lens = {1, reach}
    for c in range(step, reach, step):
        lens.update((c - 1, c, c + 1))
    lens = sorted(lens) + [0]
    b = len(lens)
    nb = b * mb + 3
    tables = torch.randperm(nb, device=dev, generator=gen)[:b * mb]
    tables = tables.view(b, mb).to(torch.int32)
    for i, n in enumerate(lens):
        tables[i, -(-n // bs):] = nb + 5 + i
    q = torch.randn(b, nh, dh, device=dev, generator=gen).to(dtype)
    kp = torch.randn(nb, bs, g, dh, device=dev, generator=gen)
    vp = torch.randn(nb, bs, g, dh, device=dev, generator=gen)
    sc = {}
    if quant:
        from apex_tpu_torch.serving.paged_cache import quantize_kv
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kp.to(pool_dtype), vp.to(pool_dtype)
    w = (torch.randn(nh * dh, 256, device=dev, generator=gen)
         * 0.03).to(w_dtype)
    ang = torch.rand(b, dh // 2, device=dev, generator=gen) * 6
    ang = torch.cat([ang, ang], -1)
    lens = torch.tensor(lens, device=dev, dtype=torch.int32)
    return (q, kp, vp, tables, lens), sc, w, ang.cos(), ang.sin()


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("nh, g, dh", PAGED_GEOMETRIES)
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_k3_fused_decode_layer(dev, dtype, tol, nh, g, dh, rope, w_dtype):
    """K3 against its plain version: every chunk edge of the plan, an
    all-sentinel empty lane (exact zeros), W in fp32 or bf16 (rounded to
    the compute dtype either way), one launch count a call."""
    args, _, w, cos, sin = _decode_operands(dev, dtype, nh, g, dh, 2,
                                            w_dtype=w_dtype)
    if not rope:
        cos = sin = None
    before = tds.DECODE_LAYER.launches
    out = tds.fused_decode_layer(*args, w, rope_cos=cos, rope_sin=sin)
    ref = tds.fused_decode_layer(*args, w, rope_cos=cos, rope_sin=sin,
                                 backend="reference")
    torch.cuda.synchronize()
    assert tds.DECODE_LAYER.launches == before + 1
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.count_nonzero(out[-1]) == 0


def test_k3_row6_threads_share_a_stream(dev):
    """K3 and row 6 called from two threads on one stream, each thread
    allocating between calls: every result equals the same call made
    alone, bit for bit.  (The chunks' scratch must outlive the launch: a
    scratch freed while its pointer was taken went back to the allocator,
    and the other thread's next tensor took it before this call's kernels
    were enqueued.)"""
    import threading

    from apex_tpu_torch.ops import paged_attention as tpa

    ops = [_decode_operands(dev, torch.bfloat16, 12, 12, 64, seed)
           for seed in (3, 4)]

    def calls(i):
        args, _, w, cos, sin = ops[i]
        return (tds.fused_decode_layer(*args, w, rope_cos=cos, rope_sin=sin),
                tpa.ragged_paged_attention(*args))

    alone = [calls(i) for i in (0, 1)]
    torch.cuda.synchronize()
    got = {0: [], 1: []}

    def worker(i):
        for _ in range(200):
            got[i].append(calls(i))
            torch.randn(1 << 14, device=dev).add_(1.0)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    for i in (0, 1):
        assert len(got[i]) == 200
        for out, paged in got[i]:
            assert torch.equal(out, alone[i][0])
            assert torch.equal(paged, alone[i][1])


def _k4_temps(b, dev, mode="mixed"):
    """Per-row temperatures: greedy rows (0) among sampled ones, or all
    greedy."""
    base = torch.tensor([0.8, 1.0, 0.0, 0.5, 1.5, 0.8, 0.0, 2.0])
    if mode == "greedy":
        base = torch.zeros(8)
    return base.repeat(-(-b // 8))[:b].to(dev)


def _k4_check(x, temps, top_k, top_p, limit, words, mask=None):
    """One call of K4 (one launch count) against _sampling_plain on the
    same inputs: token for token."""
    before = tfs.FUSED_SAMPLE.launches
    got = tfs.fused_sample(x, seed_words=words, temperature=temps,
                           top_k=top_k, top_p=top_p, vocab_limit=limit,
                           token_mask=mask)
    torch.cuda.synchronize()
    assert tfs.FUSED_SAMPLE.launches == before + 1
    xm = x if mask is None else tfs.apply_token_mask(x, mask)
    want = tfs._sampling_plain(xm, words, temps, top_k, top_p, limit)
    assert torch.equal(got.cpu(), want.cpu())
    assert int(got.max()) < limit
    return got


@pytest.mark.parametrize("top_k, top_p", [(None, None), (50, None),
                                          (None, 0.95), (50, 0.95)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("V", [50304, 152064, 262144])
def test_k4_fused_sample_token_exact(dev, top_k, top_p, dtype, b, V):
    """K4 against _sampling_plain at one and eight rows and the engine's
    32 lanes, GPT-2's, Qwen2's and Gemma's vocabularies (the latter two
    past the first version's one-SM row), fp32 and bf16 logits read in
    their own dtype, greedy rows among sampled ones."""
    gen = _gen(3)
    x = (torch.randn(b, V, device=dev, generator=gen) * 4).to(dtype)
    temps = _k4_temps(b, dev)
    for words in [(1, 2), (0xDEADBEEF, 0x12345678)]:
        _k4_check(x, temps, top_k, top_p, V - 47, words)


# (dtype, mode): fp16 logits cannot hold the mask's -1e30 (apply_token_mask
# overflows), so their holes come from bf16's and fp32's cases alone
_K4_EDGES = [(dt, mode) for dt in (torch.float32, torch.bfloat16,
                                   torch.float16)
             for mode in ("holes", "greedy", "flat", "ties")
             if not (dt == torch.float16 and mode == "holes")]


@pytest.mark.parametrize("top_k, top_p", [(None, None), (50, None),
                                          (None, 0.95), (50, 0.95)])
@pytest.mark.parametrize("dtype, mode", _K4_EDGES)
def test_k4_fused_sample_edges(dev, top_k, top_p, dtype, mode):
    """K4 with a token mask's holes (30% of the row), all-greedy rows,
    flat rows (a nucleus of most of the row: committed elements above a
    few candidate buckets), and rows tied at the 50th value and one all
    equal (more candidates than places: the row pass)."""
    gen = _gen(4)
    b, V = 8, 50304
    x = torch.randn(b, V, device=dev, generator=gen) * 4
    mask = None
    temps = _k4_temps(b, dev, "greedy" if mode == "greedy" else "mixed")
    if mode == "holes":
        mask = torch.rand(b, V, device=dev, generator=gen) > 0.3
    elif mode == "flat":
        x = torch.rand(b, V, device=dev, generator=gen) * 0.05
    elif mode == "ties":
        kth = x.topk(50, dim=-1).values[:, 45:46]
        x = torch.where((x - kth).abs() < 0.05, kth, x)
        x[0] = 1.5
    _k4_check(x.to(dtype), temps, top_k, top_p, V - 47, (9, 10), mask)


@pytest.mark.parametrize("b, V", [(8, 50304), (32, 262144)])
def test_k4_repeats_bitwise_and_replays_new_words(dev, b, V):
    """Twenty calls give the same tokens; a call captured in a CUDA graph
    with its key words in a device tensor replays each new pair of words
    copied into that tensor as an eager call with them does, one launch
    count per call."""
    gen = _gen(5)
    x = torch.randn(b, V, device=dev, generator=gen) * 4
    temps = _k4_temps(b, dev)
    kw = dict(temperature=temps, top_k=50, top_p=0.95, vocab_limit=V - 47)
    first = tfs.fused_sample(x, seed_words=(3, 4), **kw)
    for _ in range(20):
        assert torch.equal(tfs.fused_sample(x, seed_words=(3, 4), **kw),
                           first)
    words = torch.tensor([3, 4], dtype=torch.int64, device=dev)
    tfs.fused_sample(x, seed_words=words, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tfs.fused_sample(x, seed_words=words, **kw)
    draws = set()
    for pair in [(5, 6), (0xFFFFFFFF, 1), (77, 0x9E3779B9)]:
        words.copy_(torch.tensor(pair, dtype=torch.int64))
        before = tfs.FUSED_SAMPLE.launches
        graph.replay()
        eager = tfs.fused_sample(x, seed_words=pair, **kw)
        torch.cuda.synchronize()
        assert tfs.FUSED_SAMPLE.launches == before + 1
        assert torch.equal(captured, eager)
        assert torch.equal(eager.cpu(), tfs._sampling_plain(
            x, pair, temps, 50, 0.95, V - 47).cpu())
        draws.add(tuple(captured.tolist()))
    assert len(draws) > 1


def _rel_err(got, want):
    """max |got - want| over max |want|: the error of a gradient relative
    to its scale."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-6))


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2),
                                        (torch.float16, 2e-3)])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("hidden", [768, 100, 2048])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.float16])
def test_k5_layer_norm_bwd(dev, dtype, tol, rms, hidden, wdtype):
    """K5's dx, dγ, dβ against _bwd_plain, and the autograd route with
    the gradients in the parameters' dtype."""
    g = _gen(4)
    rows = 300
    x = (torch.randn(rows, hidden, device=dev, generator=g) * 2).to(dtype)
    dy = torch.randn(rows, hidden, device=dev, generator=g).to(dtype)
    w = (1 + 0.1 * torch.randn(hidden, device=dev, generator=g)).to(wdtype)
    b = None if rms else (0.1 * torch.randn(hidden, device=dev,
                                            generator=g)).to(wdtype)
    _, mu, rs = tln.layer_norm_fwd_stats(x, w, b, rms=rms)
    before = tln.LN_BWD.launches
    got = tln.layer_norm_bwd(dy, x, w, mu, rs, rms=rms, has_bias=b is not None)
    want = tln.layer_norm_bwd(dy, x, w, mu, rs, rms=rms,
                              has_bias=b is not None, backend="reference")
    torch.cuda.synchronize()
    assert tln.LN_BWD.launches == before + 1
    assert got[0].dtype == dtype
    assert _rel_err(got[0], want[0]) <= tol
    for a, e in zip(got[1:], want[1:]):
        if e is not None:
            assert a.dtype == torch.float32 and _rel_err(a, e) <= 1e-5

    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    bs = None if b is None else b.clone().requires_grad_()
    norm = tln.fused_rms_norm if rms else tln.fused_layer_norm
    args = (xs, ws) if rms else (xs, ws, bs)
    norm(*args).backward(dy)
    assert ws.grad.dtype == wdtype and xs.grad.dtype == dtype
    assert _rel_err(xs.grad, want[0]) <= tol
    assert _rel_err(ws.grad, want[1]) <= (1e-3 if wdtype == torch.float16
                                          else 1e-5)


def _flash_inputs(dtype, b, s, n, g, d, seed):
    gen = _gen(seed)
    q = torch.randn(b, s, n, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, s, g, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, s, g, d, device="cuda", generator=gen).to(dtype)
    do = torch.randn(b, s, n, d, device="cuda", generator=gen).to(dtype)
    return q, k, v, do


# p and ds are rounded to the input type before the tensor-core products
_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n, g, causal, padded, d", [
    (4, 4, True, False, 64), (4, 4, True, True, 64), (4, 4, False, True, 64),
    (12, 4, True, True, 64), (8, 1, True, True, 64), (4, 2, True, True, 128),
    (4, 4, True, True, 32), (4, 1, False, True, 128),
    (8, 2, False, False, 32), (4, 2, True, True, 40), (4, 4, True, True, 80),
    (4, 1, False, True, 96), (8, 2, True, False, 112)])
@pytest.mark.parametrize("s", [130, 1030])
def test_k6_k7_flash_attention_bwd(dev, dtype, n, g, causal, padded, d, s):
    """K6 dq and K7 dk/dv, launched directly, against
    flash_attention_bwd_ref on the same o and lse: tails past a 128-row
    tile (130, 1030), MQA and GQA, every head size; batch row 2 is fully
    masked when padded."""
    b = 3
    q, k, v, do = _flash_inputs(dtype, b, s, n, g, d, seed=5)
    kpm = None
    if padded:
        lens = torch.tensor([s, 77, 0], device=dev)
        kpm = torch.arange(s, device=dev)[None] >= lens[:, None]
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                     key_padding_mask=kpm)
    before = (tfa.FLASH_BWD_DQ.launches, tfa.FLASH_BWD_DKV.launches)
    ops = tfa.flash_bwd_operands(q, k, v, o, lse, do, key_padding_mask=kpm)
    got = (tfa.flash_bwd_dq(ops, causal=causal),
           *tfa.flash_bwd_dkv(ops, causal=causal))
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       key_padding_mask=kpm)
    torch.cuda.synchronize()
    assert (tfa.FLASH_BWD_DQ.launches,
            tfa.FLASH_BWD_DKV.launches) == (before[0] + 1, before[1] + 1)
    for a, e, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == dtype and a.shape == e.shape, name
        assert torch.isfinite(a.float()).all(), name
        assert _rel_err(a, e) <= _BWD_TOL[dtype], name
    if padded:   # the fully masked batch row has no gradient at all
        assert all(torch.count_nonzero(t[2]) == 0 for t in got)


def test_split_backward_launches_once_and_is_deterministic(dev):
    """Above SHORT_KEYS_MAX keys flash_attention_bwd launches K6 and K7
    once each (row 5 not at all), and two calls give bitwise-equal dq, dk
    and dv: every output tile has one writer and no atomics."""
    q, k, v, do = _flash_inputs(torch.bfloat16, 2, 1030, 8, 2, 64, seed=11)
    kpm = torch.arange(1030, device=dev)[None] >= torch.tensor(
        [[1030], [600]], device=dev)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True,
                                     key_padding_mask=kpm)
    runs = []
    for _ in range(2):
        before = ku.launch_counts()
        runs.append(tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                            key_padding_mask=kpm))
        torch.cuda.synchronize()
        after = ku.launch_counts()
        assert after["flash_attention_bwd_dq"] == \
            before["flash_attention_bwd_dq"] + 1
        assert after["flash_attention_bwd_dkv"] == \
            before["flash_attention_bwd_dkv"] + 1
        assert after["flash_attention_bwd_short"] == \
            before["flash_attention_bwd_short"]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_hopper_flash_kernels_in_a_cuda_graph(dev):
    """K2 and the pair K6 + K7 captured in a CUDA graph (their tensor
    maps pass by value): a replay on new inputs copied into the captured
    buffers equals the eager calls on those inputs, bit for bit."""
    args = dict(causal=True)
    q, k, v, do = _flash_inputs(torch.bfloat16, 2, 600, 4, 2, 64, seed=12)

    def step():
        o, lse = tfa.flash_attention_fwd(q, k, v, **args)
        ops = tfa.flash_bwd_operands(q, k, v, o, lse, do)
        return (o, lse, tfa.flash_bwd_dq(ops, **args),
                *tfa.flash_bwd_dkv(ops, **args))

    step()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    fresh = _flash_inputs(torch.bfloat16, 2, 600, 4, 2, 64, seed=13)
    for dst, src in zip((q, k, v, do), fresh):
        dst.copy_(src)
    graph.replay()
    eager = step()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_hopper_flash_kernels_fit_the_sm(dev, dtype, d):
    """The 16-bit K2, K6, K7 and row 5 kernels launch one 384-thread CTA
    per SM within the 227 KB of shared memory a block may use; row 5's
    cluster kernel does not spill."""
    attrs = tfa.hopper_attributes(dtype, d)
    assert set(attrs) == {"flash_attention_fwd", "flash_attention_bwd_dq",
                          "flash_attention_bwd_dkv",
                          "flash_attention_bwd_short"}
    for a in attrs.values():
        assert a["ctas_per_sm"] >= 1 and a["smem_bytes"] <= 232448
        assert 0 < a["registers"] <= 168
    assert attrs["flash_attention_bwd_short"]["spill_bytes"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("s, n, g, causal, padded, d", [
    (512, 4, 4, False, True, 64), (200, 4, 4, False, False, 64),
    (130, 4, 4, True, True, 64), (130, 12, 4, False, True, 64),
    (512, 8, 1, True, True, 64), (77, 4, 2, False, True, 128),
    (130, 4, 4, True, True, 32), (384, 8, 2, True, True, 64),
    (300, 4, 4, False, True, 32), (257, 4, 1, True, True, 128),
    (511, 12, 12, True, False, 64), (450, 8, 4, False, True, 128),
    (512, 8, 2, True, True, 40), (384, 4, 4, True, True, 80),
    (300, 4, 1, False, True, 96), (200, 8, 2, True, False, 112)])
def test_row5_flash_bwd_short(dev, dtype, s, n, g, causal, padded, d):
    """Row 5 (the route of flash_attention_bwd up to 512 keys) against
    flash_attention_bwd_ref and against K6 + K7 on the same o and lse:
    clusters of 1 to 4 ranks (77 .. 512 keys), key tails inside a rank's
    128 keys, every head size, MQA and GQA; batch row 2 is fully masked
    when padded."""
    b = 3
    q, k, v, do = _flash_inputs(dtype, b, s, n, g, d, seed=7)
    kpm = None
    if padded:
        lens = torch.tensor([s, s // 2 + 3, 0], device=dev)
        kpm = torch.arange(s, device=dev)[None] >= lens[:, None]
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                     key_padding_mask=kpm)
    before = ku.launch_counts()
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  key_padding_mask=kpm)
    torch.cuda.synchronize()
    after = ku.launch_counts()
    assert after["flash_attention_bwd_short"] == \
        before["flash_attention_bwd_short"] + 1
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name]
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       key_padding_mask=kpm)
    ops = tfa.flash_bwd_operands(q, k, v, o, lse, do, key_padding_mask=kpm)
    split = (tfa.flash_bwd_dq(ops, causal=causal),
             *tfa.flash_bwd_dkv(ops, causal=causal))
    torch.cuda.synchronize()
    for a, e, sp, name in zip(got, want, split, ("dq", "dk", "dv")):
        assert a.dtype == dtype and a.shape == e.shape, name
        assert torch.isfinite(a.float()).all(), name
        assert _rel_err(a, e) <= _BWD_TOL[dtype], name
        assert _rel_err(a, sp) <= _BWD_TOL[dtype], name
    if padded:
        assert all(torch.count_nonzero(t[2]) == 0 for t in got)


@pytest.mark.parametrize("s, causal, d", [(640, True, 64), (1000, False, 64),
                                          (1024, True, 128), (896, False, 32)])
def test_row5_cluster_up_to_eight_ranks(dev, s, causal, d):
    """flash_bwd_fused launched directly past SHORT_KEYS_MAX: clusters of
    5 to 8 ranks (the crossover sweep's key lengths) against
    flash_attention_bwd_ref and K6 + K7, one launch; above 1024 keys the
    cluster would exceed 8 ranks and the call is refused."""
    q, k, v, do = _flash_inputs(torch.bfloat16, 2, s, 4, 2, d, seed=14)
    kpm = torch.arange(s, device=dev)[None] >= torch.tensor(
        [[s], [s // 3]], device=dev)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                     key_padding_mask=kpm)
    ops = tfa.flash_bwd_operands(q, k, v, o, lse, do, key_padding_mask=kpm)
    before = tfa.FLASH_BWD_SHORT.launches
    got = tfa.flash_bwd_fused(ops, causal=causal)
    torch.cuda.synchronize()
    assert tfa.FLASH_BWD_SHORT.launches == before + 1
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       key_padding_mask=kpm)
    split = (tfa.flash_bwd_dq(ops, causal=causal),
             *tfa.flash_bwd_dkv(ops, causal=causal))
    for a, e, sp in zip(got, want, split):
        assert _rel_err(a, e) <= _BWD_TOL[torch.bfloat16]
        assert _rel_err(a, sp) <= _BWD_TOL[torch.bfloat16]
    q, k, v, do = _flash_inputs(torch.bfloat16, 1, 1030, 4, 4, 64, seed=15)
    o, lse = tfa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError):
        tfa.flash_bwd_fused(tfa.flash_bwd_operands(q, k, v, o, lse, do),
                            causal=False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_row5_repeats_bitwise_and_captures(dev, dtype):
    """Twenty launches of row 5's cluster kernel at BERT's shape (b8 s512
    n16 d64, key padding) give the same bits (one writer per element, a
    fixed order of addition across the cluster), and a launch captured in
    a CUDA graph replays on new inputs as the eager call does."""
    s = 512
    q, k, v, do = _flash_inputs(dtype, 8, s, 16, 16, 64, seed=16)
    lens = torch.tensor([512, 400, 387, 500, 450, 420, 460, 0], device=dev)
    kpm = torch.arange(s, device=dev)[None] >= lens[:, None]
    o, lse = tfa.flash_attention_fwd(q, k, v, key_padding_mask=kpm)
    ops = tfa.flash_bwd_operands(q, k, v, o, lse, do, key_padding_mask=kpm)
    first = tfa.flash_bwd_fused(ops, causal=False)
    for _ in range(20):
        assert all(torch.equal(a, b)
                   for a, b in zip(tfa.flash_bwd_fused(ops, causal=False),
                                   first))
    assert all(int(torch.count_nonzero(t[-1])) == 0 for t in first)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tfa.flash_bwd_fused(ops, causal=False)
    fresh = _flash_inputs(dtype, 8, s, 16, 16, 64, seed=17)
    for name, src in zip(("q", "k", "v", "do"), fresh):
        ops[name].copy_(src)
    graph.replay()
    eager = tfa.flash_bwd_fused(ops, causal=False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))


def test_row5_is_deterministic_and_long_keys_take_k6_k7(dev):
    q, k, v, do = _flash_inputs(torch.bfloat16, 2, 512, 16, 16, 64, seed=8)
    o, lse = tfa.flash_attention_fwd(q, k, v)
    first = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    again = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    q, k, v, do = _flash_inputs(torch.bfloat16, 1, 520, 4, 4, 64, seed=9)
    o, lse = tfa.flash_attention_fwd(q, k, v)
    before = ku.launch_counts()
    tfa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    after = ku.launch_counts()
    assert after["flash_attention_bwd_short"] == \
        before["flash_attention_bwd_short"]
    assert after["flash_attention_bwd_dq"] == \
        before["flash_attention_bwd_dq"] + 1


def test_flash_autograd_matches_reference_route(dev):
    q, k, v, do = _flash_inputs(torch.bfloat16, 2, 200, 12, 4, 64, seed=6)
    kpm = torch.arange(200, device=dev)[None] >= torch.tensor(
        [[200], [150]], device=dev)
    grads = []
    for backend in (None, "reference"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = tfa.flash_attention(*leaves, causal=True, key_padding_mask=kpm,
                                  backend=backend)
        out.backward(do)
        grads.append([t.grad for t in leaves])
    for a, e in zip(*grads):
        assert _rel_err(a, e) <= _BWD_TOL[torch.bfloat16]


# both sides compute in fp32 and round once to the input type
_SOFTMAX_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8,
                torch.float16: 2.0 ** -11}


def _softmax_mask(kind, b, n, sq, sk, dev):
    gen = _gen(11)
    if kind == "none" or kind == "causal":
        return None
    if kind == "key_padding":             # [b, 1, 1, sk], row 1 all masked
        lens = torch.tensor([sk, 0] + [sk // 2 + 1] * (b - 2), device=dev)
        return (torch.arange(sk, device=dev)[None] >= lens[:, None])[
            :, None, None, :]
    shape = (b, 1, sq, sk) if kind == "per_query" else (b, n, sq, sk)
    m = torch.rand(shape, device=dev, generator=gen) < 0.4
    m[0, 0, 3] = True                     # one fully masked row
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("kind", ["none", "key_padding", "per_query",
                                  "full", "causal"])
@pytest.mark.parametrize("sk", [40, 512, 1100])
def test_row11_scaled_softmax(dev, dtype, kind, sk):
    """Row 11 against _softmax_fwd_ref: broadcast and full masks, causal,
    fully masked rows, row lengths that are not a multiple of 128 and
    longer than 1024."""
    b, n = 3, 2
    sq = sk if kind == "causal" else 24
    x = (torch.randn(b, n, sq, sk, device=dev, generator=_gen(10))
         * 4).to(dtype)
    mask = _softmax_mask(kind, b, n, sq, sk, dev)
    before = tsm.SOFTMAX_FWD.launches
    got = tsm.softmax_fwd(x, 0.5, mask, kind == "causal")
    torch.cuda.synchronize()
    assert tsm.SOFTMAX_FWD.launches == before + 1
    want = tsm._softmax_fwd_ref(x, 0.5, mask, kind == "causal")
    assert got.dtype == dtype and got.shape == x.shape
    assert max_abs(got, want) <= _SOFTMAX_TOL[dtype]
    if kind == "key_padding":
        assert torch.count_nonzero(got[1]) == 0


def _row11_check(x, mask, causal, scale=0.5):
    """One launch of row 11, held against the plain version."""
    before = tsm.SOFTMAX_FWD.launches
    got = tsm.softmax_fwd(x, scale, mask, causal)
    torch.cuda.synchronize()
    assert tsm.SOFTMAX_FWD.launches == before + 1
    want = tsm._softmax_fwd_ref(x, scale, mask, causal)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert max_abs(got, want) <= _SOFTMAX_TOL[x.dtype]
    return got


def _row11_plan(x, mask=None):
    m = None if mask is None else tsm._mask_view(mask, x.shape)
    return tsm.softmax_plan(x.shape[-1], x.element_size(), x.data_ptr(),
                            x.data_ptr(), None if m is None
                            else m.data_ptr(),
                            None if m is None else m.stride())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sk", [1, 31, 512, 1024, 1025, 2048, 2049])
def test_row11_variant_boundaries(dev, dtype, sk, masked):
    """sk on both sides of each variant's edge: 1 and 31 (unaligned
    rows, looped one element at a time), 512, 1024 and 2048 (read once
    up to 1024 fp32 / 2048 16-bit values, looped in vectors past them),
    1025 and 2049 (unaligned again); with a key-padding mask whose batch
    row 1 is fully masked."""
    b, n, sq = 3, 2, 8
    x = (torch.randn(b, n, sq, sk, device=dev, generator=_gen(20))
         * 4).to(dtype)
    mask = None
    if masked:
        lens = torch.tensor([sk, 0, sk // 2 + 1], device=dev)
        mask = (torch.arange(sk, device=dev)[None] >= lens[:, None])[
            :, None, None, :]
    plan = _row11_plan(x, mask)
    vec = 16 // x.element_size()
    fits = sk % vec == 0 and sk // vec <= 32 * tsm.ROW_MAX_VECTORS
    assert (plan.lanes > 0) == fits
    got = _row11_check(x, mask, False)
    if masked:
        assert torch.count_nonzero(got[1]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sk", [512, 1024])
def test_row11_unaligned_input(dev, dtype, sk):
    """x a contiguous view one element into a larger buffer: the rows
    are not 16-byte aligned, so the looped kernel reads one element at a
    time."""
    b, n, sq = 2, 3, 16
    numel = b * n * sq * sk
    buf = (torch.randn(numel + 1, device=dev, generator=_gen(21))
           * 4).to(dtype)
    x = buf[1:1 + numel].view(b, n, sq, sk)
    mask = torch.rand(b, 1, sq, sk, device=dev, generator=_gen(22)) < 0.3
    plan = _row11_plan(x, mask)
    assert plan.lanes == 0 and plan.vec == 1
    _row11_check(x, mask, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sk", [64, 512, 1100])
def test_row11_mask_with_last_stride_not_one(dev, dtype, sk):
    """A transposed mask (last stride sq) is read element by element
    through its strides."""
    b, n, sq = 2, 2, 24
    x = (torch.randn(b, n, sq, sk, device=dev, generator=_gen(23))
         * 4).to(dtype)
    mask = (torch.rand(b, 1, sk, sq, device=dev, generator=_gen(24))
            < 0.4).transpose(-1, -2)
    mask[0, 0, 5] = True                  # one fully masked row
    assert mask.stride()[-1] != 1
    assert _row11_plan(x, mask).mask == tsm.MASK_STRIDED
    got = _row11_check(x, mask, False)
    assert torch.count_nonzero(got[0, :, 5]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("s", [40, 512, 1024, 1100])
def test_row11_causal_square(dev, dtype, s):
    """The causal triangle on square inputs: the vectors past the
    diagonal are not read, and no row is dead."""
    x = (torch.randn(2, 2, s, s, device=dev, generator=_gen(25))
         * 4).to(dtype)
    got = _row11_check(x, None, True)
    assert torch.count_nonzero(got.float().triu(1)) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sk", [40, 512, 1100, 2048])
def test_row11_fully_masked_rows_are_exact_zeros(dev, dtype, sk):
    """Rows with every element masked (a zero key length, a per-query
    mask row of all True) are exact zeros, whatever x holds (here inf
    and nan, which a row that read x would carry)."""
    b, n, sq = 3, 2, 8
    x = (torch.randn(b, n, sq, sk, device=dev, generator=_gen(26))
         * 4).to(dtype)
    x[1] = float("nan")
    x[2, :, 3] = float("inf")
    mask = torch.rand(b, 1, sq, sk, device=dev, generator=_gen(27)) < 0.3
    mask[1] = True
    mask[2, :, 3] = True
    got = tsm.softmax_fwd(x, 0.5, mask)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[1]) == 0
    assert torch.count_nonzero(got[2, :, 3]) == 0
    want = tsm._softmax_fwd_ref(x[0], 0.5, mask[0])
    assert max_abs(got[0], want) <= _SOFTMAX_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row11_repeats_bitwise_and_captures(dev, dtype):
    """At BERT's fused_softmax shape ([8, 16, 512, 512], [8, 1, 1, 512]
    key padding, one batch row fully masked) twenty launches give the same
    bits, and a launch captured in a CUDA graph replays on new inputs as
    the eager call does."""
    b, n, s = 8, 16, 512
    x = (torch.randn(b, n, s, s, device=dev, generator=_gen(28))
         * 8).to(dtype)
    lens = torch.tensor([512, 400, 387, 500, 450, 420, 460, 0], device=dev)
    mask = (torch.arange(s, device=dev)[None] >= lens[:, None])[
        :, None, None, :]
    first = _row11_check(x, mask, False, scale=0.125)
    for _ in range(20):
        assert torch.equal(tsm.softmax_fwd(x, 0.125, mask), first)
    assert torch.count_nonzero(first[-1]) == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tsm.softmax_fwd(x, 0.125, mask)
    x.copy_(torch.randn(b, n, s, s, device=dev, generator=_gen(29)) * 8)
    graph.replay()
    eager = tsm.softmax_fwd(x, 0.125, mask)
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    assert not torch.equal(captured, first)


def test_row11_through_autograd_and_fused_module(dev):
    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

    x = torch.randn(2, 4, 64, 64, device=dev, generator=_gen(12))
    dy = torch.randn(2, 4, 64, 64, device=dev, generator=_gen(13))
    mask = torch.rand(2, 1, 1, 64, device=dev, generator=_gen(14)) < 0.3
    grads = []
    for backend in (None, "reference"):
        xs = x.clone().requires_grad_()
        y = tsm.scaled_masked_softmax(xs, mask, 0.125, backend=backend)
        y.backward(dy)
        grads.append((y.detach(), xs.grad))
    assert max_abs(grads[0][0], grads[1][0]) <= 1e-6
    assert _rel_err(grads[0][1], grads[1][1]) <= 1e-5
    for kind in (AttnMaskType.causal, AttnMaskType.padding):
        mod = FusedScaleMaskSoftmax(attn_mask_type=kind, scale=0.5)
        before = tsm.SOFTMAX_FWD.launches
        y = mod(x, None if kind == AttnMaskType.causal else mask)
        torch.cuda.synchronize()
        assert tsm.SOFTMAX_FWD.launches == before + 1
        assert torch.isfinite(y).all()


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("nh, g, dh", PAGED_GEOMETRIES)
@pytest.mark.parametrize("quant", [False, True])
def test_row6_ragged_paged_attention(dev, dtype, tol, nh, g, dh, quant):
    """Row 6 against its plain version at every chunk edge of the plan,
    native and int8 pools, an all-sentinel empty lane (exact zeros), one
    launch count a call."""
    from apex_tpu_torch.ops import paged_attention as tpa

    args, sc, *_ = _decode_operands(dev, dtype, nh, g, dh, 7, quant=quant)
    before = tpa.PAGED_ATTENTION.launches
    out = tpa.ragged_paged_attention(*args, **sc)
    ref = tpa.ragged_paged_attention(*args, backend="reference", **sc)
    torch.cuda.synchronize()
    assert tpa.PAGED_ATTENTION.launches == before + 1
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.count_nonzero(out[-1]) == 0      # the empty lane


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("nh, g, dh", PAGED_GEOMETRIES)
@pytest.mark.parametrize("rope", [False, True])
def test_k3_fused_decode_layer_int8_pool(dev, dtype, tol, nh, g, dh, rope):
    args, sc, w, cos, sin = _decode_operands(dev, dtype, nh, g, dh, 8,
                                             quant=True)
    if not rope:
        cos = sin = None
    before = tds.DECODE_LAYER.launches
    out = tds.fused_decode_layer(*args, w, rope_cos=cos, rope_sin=sin, **sc)
    ref = tds.fused_decode_layer(*args, w, rope_cos=cos, rope_sin=sin,
                                 backend="reference", **sc)
    torch.cuda.synchronize()
    assert tds.DECODE_LAYER.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.count_nonzero(out[-1]) == 0


# rows 6 and 7 over a pool whose dtype differs from the compute dtype (the
# engine's and generate's cache_dtype): every pair of two float dtypes,
# the tolerance of the coarser compute dtype
FLOAT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
FOREIGN_POOLS = [(q, p) for q in FLOAT_TOL for p in FLOAT_TOL if q != p]


@pytest.mark.parametrize("dtype, pool_dtype", FOREIGN_POOLS)
@pytest.mark.parametrize("nh, g, dh", [(12, 12, 64), (12, 4, 64),
                                       (12, 1, 64), (16, 1, 128)])
@pytest.mark.parametrize("kernel", ["row6", "k3"])
def test_paged_decode_foreign_pool_dtype(dev, dtype, pool_dtype, nh, g, dh,
                                         kernel):
    """Rows 6 and 7 read a pool of another float dtype than q's (widened
    in registers as it streams) and agree with the plain versions, which
    cast; one launch count a call, the output in q's dtype, the empty lane
    exact zeros."""
    from apex_tpu_torch.ops import paged_attention as tpa

    args, _, w, cos, sin = _decode_operands(dev, dtype, nh, g, dh, 13,
                                            pool_dtype=pool_dtype)
    tol = max(FLOAT_TOL[dtype], FLOAT_TOL[pool_dtype])
    if kernel == "row6":
        counter, fn, kw = tpa.PAGED_ATTENTION, tpa.ragged_paged_attention, {}
    else:
        counter, fn = tds.DECODE_LAYER, tds.fused_decode_layer
        args = args + (w,)
        kw = dict(rope_cos=cos, rope_sin=sin)
    before = counter.launches
    out = fn(*args, **kw)
    ref = fn(*args, backend="reference", **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.count_nonzero(out[-1]) == 0


@pytest.mark.parametrize("kernel", ["row6", "k3"])
@pytest.mark.parametrize("nh, g, dh, quant", [(12, 12, 64, False),
                                              (12, 12, 64, True),
                                              (12, 1, 64, False),
                                              (32, 1, 128, True)])
def test_paged_decode_repeats_bitwise_and_captures(dev, kernel, nh, g, dh,
                                                   quant):
    """Twenty calls give the same bits (the rank-order combine), and a call
    captured in a CUDA graph replays with other lengths written into the
    captured lengths tensor exactly as an eager call with those lengths:
    the grid depends on the tables' reach, not on the lengths."""
    from apex_tpu_torch.ops import paged_attention as tpa

    args, sc, w, cos, sin = _decode_operands(dev, torch.bfloat16, nh, g, dh,
                                             11, quant=quant)
    q, kp, vp, tables, lens = args
    reach = tables.shape[1] * kp.shape[1]

    def call():
        if kernel == "row6":
            return tpa.ragged_paged_attention(q, kp, vp, tables, lens, **sc)
        return tds.fused_decode_layer(q, kp, vp, tables, lens, w,
                                      rope_cos=cos, rope_sin=sin, **sc)

    first = call()
    for _ in range(20):
        assert torch.equal(call(), first)
    counter = tpa.PAGED_ATTENTION if kernel == "row6" else tds.DECODE_LAYER
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    before = counter.launches
    for shift in (37, 101):
        # other lengths, inside the reach the tables map (an empty lane
        # stays empty: its table holds only sentinels)
        new = (lens.long() * 0 + torch.arange(lens.numel(), device=dev)
               * shift % reach)
        new[-1] = 0
        mapped = (tables < kp.shape[0]).sum(1) * kp.shape[1]
        lens.copy_(torch.minimum(new, mapped).to(torch.int32))
        graph.replay()
        eager = call()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
        ref = (tpa.ragged_paged_attention(q, kp, vp, tables, lens,
                                          backend="reference", **sc)
               if kernel == "row6" else
               tds.fused_decode_layer(q, kp, vp, tables, lens, w,
                                      rope_cos=cos, rope_sin=sin,
                                      backend="reference", **sc))
        torch.testing.assert_close(captured.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
    assert counter.launches == before + 2          # the two eager calls
    assert not torch.equal(captured, first)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2),
                                        (torch.float16, 4e-3)])
@pytest.mark.parametrize("m", [1, 32, 77, 1024])
@pytest.mark.parametrize("k, n, block", [(768, 2304, None), (3072, 768, None),
                                         (96, 40, 32), (100, 24, None)])
def test_row10_dense_int8(dev, dtype, tol, m, k, n, block):
    """Tensor-core tiles (kb % 32 == 0, n % 16 == 0, 16-bit x), the
    CUDA-core path (fp32 x, odd shapes), ragged row counts."""
    from apex_tpu_torch.ops import dense as td

    gen = _gen(10)
    w = torch.randn(k, n, device=dev, generator=gen) * 0.05
    slab = td.quantize_weight(w, block)
    x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
    kern = _row10_kernel(m, slab, dtype)
    before = dict(ku.launch_counts())
    out = td.dense_quantized(x, slab["wire"], slab["scale"])
    ref = td.dense_quantized(x, slab["wire"], slab["scale"],
                             backend="reference")
    torch.cuda.synchronize()
    before[kern.name] += 1
    assert ku.launch_counts() == before     # one launch, on its route
    assert out.dtype == dtype and out.shape == (m, n)
    # relative to the output's scale: fp32 sums in another order, and a
    # 16-bit output rounds once
    assert _rel_err(out, ref) <= tol


def _row10_kernel(m, slab, dtype):
    """The launch counter of the route dense_quantized takes."""
    from apex_tpu_torch.ops import dense as td

    k, n = slab["wire"].shape
    kb = k // slab["scale"].shape[0]
    return {"tiles": td.DENSE_INT8, "decode": td.DENSE_INT8_DECODE,
            "simt": td.DENSE_INT8_SIMT}[td.dense_route(m, k, n, kb, dtype)]


@pytest.mark.parametrize("dtype, tol", [(torch.bfloat16, 1e-2),
                                        (torch.float16, 4e-3)])
@pytest.mark.parametrize("m", [1, 7, 32, 33, 64, 65, 1024, 4096])
@pytest.mark.parametrize("k, n, block", [
    (768, 2304, 128),     # qkv: six scale blocks
    (3072, 768, 128),     # fc2: 24 blocks, a full cluster of 8
    (256, 272, 128),      # n not a multiple of 128 (nor of 64)
    (128, 384, 128),      # k = kb: a single scale block
    (256, 640, 128),      # two blocks, fewer than the cluster's 8
    (192, 96, 32)])       # kb = 32: several blocks per 64 rows of k
def test_row10_tensor_core_routes(dev, dtype, tol, m, k, n, block):
    """The two Hopper routes of row 10: the swapped, cluster-split decode
    kernel at m <= 64 and the int8-slab GEMM above, one launch each on
    its own counter, the plain version's result within a 16-bit
    rounding, bitwise the same over repeated launches."""
    from apex_tpu_torch.ops import dense as td

    gen = _gen(40)
    w = torch.randn(k, n, device=dev, generator=gen) * 0.05
    slab = td.quantize_weight(w, block)
    assert slab["scale"].shape[0] == k // block
    x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
    kern = _row10_kernel(m, slab, dtype)
    assert kern is (td.DENSE_INT8_DECODE if m <= 64 else td.DENSE_INT8)
    before = dict(ku.launch_counts())
    out = td.dense_quantized(x, slab["wire"], slab["scale"])
    torch.cuda.synchronize()
    before[kern.name] += 1
    assert ku.launch_counts() == before
    ref = td.dense_quantized(x, slab["wire"], slab["scale"],
                             backend="reference")
    assert out.dtype == dtype and out.shape == (m, n)
    assert _rel_err(out, ref) <= tol
    for _ in range(3):
        again = td.dense_quantized(x, slab["wire"], slab["scale"])
        assert torch.equal(again, out)


@pytest.mark.parametrize("m", [1, 32, 64])
@pytest.mark.parametrize("k, n", [(768, 2304), (3072, 768), (256, 272)])
def test_row10_every_cluster_size_agrees(dev, m, k, n):
    """Each cluster size of the decode route (1 .. min(8, k / kb) CTAs,
    whole scale blocks each, uneven splits included) gives the plain
    result, and each is deterministic."""
    from apex_tpu_torch.ops import dense as td

    gen = _gen(41)
    slab = td.quantize_weight(torch.randn(k, n, device=dev, generator=gen)
                              * 0.05)
    x = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
    ref = td.dense_quantized(x, slab["wire"], slab["scale"],
                             backend="reference")
    nkb = slab["scale"].shape[0]
    for splits in range(1, min(td.MAX_CLUSTER, nkb) + 1):
        out = td._dq_kernel(x, slab["wire"], slab["scale"], splits=splits)
        again = td._dq_kernel(x, slab["wire"], slab["scale"], splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert _rel_err(out, ref) <= 1e-2, splits


@pytest.mark.parametrize("m", [32, 1024])
def test_row10_captures_in_a_cuda_graph(dev, m):
    """Both Hopper routes (the decode route a cluster launch) capture in
    a CUDA graph, and a replay follows new activations copied in place."""
    from apex_tpu_torch.ops import dense as td

    gen = _gen(42)
    slab = td.quantize_weight(torch.randn(768, 3072, device=dev,
                                          generator=gen) * 0.05)
    x = torch.randn(m, 768, device=dev, generator=gen).to(torch.bfloat16)
    static = x.clone()
    with torch.no_grad():
        td.dense_quantized(static, slab["wire"], slab["scale"])
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = td.dense_quantized(static, slab["wire"], slab["scale"])
        for seed in (43, 44):
            new = torch.randn(m, 768, device=dev,
                              generator=_gen(seed)).to(torch.bfloat16)
            static.copy_(new)
            graph.replay()
            torch.cuda.synchronize()
            want = td.dense_quantized(new, slab["wire"], slab["scale"])
            assert torch.equal(out, want)


def _gmm_inputs(case, k, p, dtype, seed):
    from torch_gmm_cases import offsets_case

    n, g, off = offsets_case(case)
    gen = _gen(seed)
    x = torch.randn(n, k, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(g, k, p, device="cuda", generator=gen) * 0.1).to(dtype)
    return x, w, torch.as_tensor(off, device="cuda"), off


def _check_gmm(x, w, offs, off_np, out, tol):
    from apex_tpu_torch.ops import grouped_matmul as tgm

    ref = tgm.grouped_matmul(x, w, offs, backend="reference")
    assert out.dtype == ref.dtype and out.shape == ref.shape
    lo, hi = int(off_np[0]), int(off_np[-1])
    # rows outside the window are exact zeros (the no-adapter lanes)
    assert int(torch.count_nonzero(out[:lo])) == 0
    assert int(torch.count_nonzero(out[hi:])) == 0
    if hi > lo:
        assert _rel_err(out, ref) <= tol


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("k, p", [(768, 8), (3072, 8), (8, 2304), (8, 768),
                                  (8, 3072)])
@pytest.mark.parametrize("case", ["decode", "prefill"])
def test_row9_grouped_matmul_lora_shapes(dev, dtype, tol, k, p, case):
    """The LoRA path's A side (k = 768/3072, p = 8) and B side (k = 8) at
    decode (32 lanes over 20 live groups of 24) and at an adapter prefill
    (1024 rows of one group)."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    x, w, offs, off_np = _gmm_inputs(case, k, p, dtype, 20)
    # fp32 (LoRA's slabs) runs the CUDA-core branch; 16-bit operands of
    # these shapes the tensor-core branch
    kernel = (tgm.GROUPED_MATMUL if dtype == torch.float32
              else tgm.GROUPED_MATMUL_MMA)
    before = kernel.launches
    out = tgm.grouped_matmul(x, w, offs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _check_gmm(x, w, offs, off_np, out, tol)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2),
                                        (torch.float16, 2e-3)])
@pytest.mark.parametrize("k, p", [(100, 24), (8, 300), (768, 8), (0, 5)])
@pytest.mark.parametrize("case", ["empty_groups", "window", "one_group",
                                  "all_outside", "ragged_300",
                                  "many_groups"])
def test_row9_grouped_matmul_adversarial(dev, dtype, tol, k, p, case):
    """Empty groups, a window (offsets[0] > 0 and offsets[-1] < N), G = 1,
    every row outside, N not a multiple of the 16-row tile, more than 32
    segments (G = 70), k = 0."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    x, w, offs, off_np = _gmm_inputs(case, k, p, dtype, 21)
    out = tgm.grouped_matmul(x, w, offs)
    torch.cuda.synchronize()
    _check_gmm(x, w, offs, off_np, out, tol)


@pytest.mark.parametrize("k, p", [(768, 8), (3072, 8), (1000, 40),
                                  (8, 2304), (5, 3)])
@pytest.mark.parametrize("case", ["decode", "prefill", "window",
                                  "many_groups"])
@pytest.mark.parametrize("rows", [4, 16])
def test_row9_contraction_splits_agree(dev, k, p, case, rows):
    """Every cluster size (1 to 8 CTAs sharing the contraction, at most
    one per k row) and both row tiles give the plain result with zeros
    outside the window, each in one launch and bitwise the same over 20
    launches (the partials are added in rank order through distributed
    shared memory)."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    x, w, offs, off_np = _gmm_inputs(case, k, p, torch.float32, 22)
    for splits in range(1, min(8, k) + 1):
        before = tgm.GROUPED_MATMUL.launches
        out = tgm._gmm_fp32_kernel(x, w, offs, splits=splits, rows=rows)
        assert tgm.GROUPED_MATMUL.launches == before + 1
        for _ in range(20):
            again = tgm._gmm_fp32_kernel(x, w, offs, splits=splits,
                                         rows=rows)
            assert torch.equal(out, again)
        torch.cuda.synchronize()
        _check_gmm(x, w, offs, off_np, out, 1e-5)


def test_row9_offsets_stay_on_the_device(dev):
    """No host read of the offsets: the launch captures in a CUDA graph,
    and a replay after the offsets change in place follows the new
    offsets."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    x, w, offs, off_np = _gmm_inputs("decode", 768, 8, torch.float32, 23)
    static = offs.clone()
    with torch.no_grad():
        tgm.grouped_matmul(x, w, static)          # build, warm
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = tgm.grouped_matmul(x, w, static)
        # the decode layout, every row outside, all rows in group 11
        for case_off in (off_np.tolist(), [32] * 25, [0] * 12 + [32] * 13):
            new = torch.tensor(case_off, dtype=torch.int32, device=dev)
            static.copy_(new)
            graph.replay()
            torch.cuda.synchronize()
            want = tgm.grouped_matmul(x, w, new, backend="reference")
            assert int(torch.count_nonzero(out[:case_off[0]])) == 0
            if case_off[0] < 32:
                assert _rel_err(out, want) <= 1e-5


def _gmm_t_inputs(case, k, p, dtype, seed):
    """x [N, k] and a slab stored as [G, p, k]: the backward's dx reads
    it as w[g]^T without a copy."""
    x, w, offs, off_np = _gmm_inputs(case, k, p, dtype, seed)
    return x, w.transpose(1, 2).contiguous(), offs, off_np


@pytest.mark.parametrize("dtype, tol", [(torch.bfloat16, 1e-2),
                                        (torch.float16, 2e-3)])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("k, p", [(64, 64), (32, 72), (8, 16), (768, 256),
                                  (0, 8)])
@pytest.mark.parametrize("case", ["moe_small", "empty_groups", "window",
                                  "one_group", "all_outside", "ragged_300",
                                  "many_groups", "straddle", "skewed"])
def test_row9_mma_branch(dev, dtype, tol, trans, k, p, case):
    """The 16-bit tensor-core branch, forward and transposed read: K and
    P at the tile's limits (one k step, one 64-column tile, a partial
    column tile, K = 0), N < 64, windows, empty groups, G = 70.  Rows
    outside the window are exact zeros, and the result is the plain
    version's within a 16-bit rounding."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    if trans:
        x, w, offs, off_np = _gmm_t_inputs(case, k, p, dtype, 24)
    else:
        x, w, offs, off_np = _gmm_inputs(case, k, p, dtype, 24)
    kernel = tgm.GROUPED_MATMUL_MMA_T if trans else tgm.GROUPED_MATMUL_MMA
    before, other = kernel.launches, tgm.GROUPED_MATMUL.launches
    out = tgm._gmm_kernel(x, w, offs, trans=trans)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert tgm.GROUPED_MATMUL.launches == other
    wf = w.transpose(1, 2) if trans else w
    _check_gmm(x, wf, offs, off_np, out, tol)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("k, p", [(768, 3072), (3072, 768)])
def test_row9_mma_branch_moe_shape(dev, trans, k, p):
    """The ragged MoE step's fc1 and fc2 (N = 4096 over 8 uneven experts,
    bf16), forward and the transposed dx read."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    fn = _gmm_t_inputs if trans else _gmm_inputs
    x, w, offs, off_np = fn("moe", k, p, torch.bfloat16, 25)
    out = tgm._gmm_kernel(x, w, offs, trans=trans)
    torch.cuda.synchronize()
    _check_gmm(x, w.transpose(1, 2) if trans else w, offs, off_np, out, 1e-2)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("k, p, dtype", [(100, 24, torch.bfloat16),
                                         (24, 100, torch.bfloat16),
                                         (64, 64, torch.float32)])
def test_row9_shapes_the_tile_does_not_take(dev, trans, k, p, dtype):
    """K or P not a multiple of 8, or fp32 operands: the fp32 branch, with
    a transposed weight as a contiguous copy; never the tile."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    fn = _gmm_t_inputs if trans else _gmm_inputs
    x, w, offs, off_np = fn("window", k, p, dtype, 26)
    mma = tgm.GROUPED_MATMUL_MMA.launches + tgm.GROUPED_MATMUL_MMA_T.launches
    before = tgm.GROUPED_MATMUL.launches
    out = tgm._gmm_kernel(x, w, offs, trans=trans)
    torch.cuda.synchronize()
    assert tgm.GROUPED_MATMUL.launches == before + 1
    assert (tgm.GROUPED_MATMUL_MMA.launches
            + tgm.GROUPED_MATMUL_MMA_T.launches) == mma
    _check_gmm(x, w.transpose(1, 2) if trans else w, offs, off_np, out,
               1e-5 if dtype == torch.float32 else 1e-2)


def _gmmq_inputs(case, k, p, block, dtype, seed):
    from apex_tpu_torch.ops import grouped_matmul as tgm

    x, w, offs, off_np = _gmm_inputs(case, k, p, torch.float32, seed)
    q = tgm.quantize_group_weights(w, block)
    return x.to(dtype), q["wire"], q["scale"], offs, off_np


@pytest.mark.parametrize("dtype, tol", [(torch.bfloat16, 1e-2),
                                        (torch.float16, 2e-3)])
@pytest.mark.parametrize("k, p, block", [(768, 3072, 128), (256, 64, 128),
                                         (64, 80, 32), (96, 16, 32)])
@pytest.mark.parametrize("case", ["moe", "moe_small", "empty_groups",
                                  "window", "all_outside", "many_groups",
                                  "straddle", "skewed"])
def test_row9_int8_branch(dev, dtype, tol, k, p, block, case):
    """The int8-slab branch against its plain version (the slab
    dequantized to fp32, one masked fp32 product per group): several
    scale blocks per K or one, P at one column tile and above, windows,
    N < 64, G = 70."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    if case == "moe" and k != 768:
        pytest.skip("the MoE layout runs at the MoE slab shape only")
    x, wire, scale, offs, off_np = _gmmq_inputs(case, k, p, block, dtype, 27)
    before = tgm.GROUPED_MATMUL_INT8.launches
    out = tgm.grouped_matmul_quantized(x, wire, scale, offs)
    torch.cuda.synchronize()
    assert tgm.GROUPED_MATMUL_INT8.launches == before + 1
    ref = tgm.grouped_matmul_quantized(x, wire, scale, offs,
                                       backend="reference")
    assert out.dtype == dtype == ref.dtype and out.shape == ref.shape
    lo, hi = int(off_np[0]), int(off_np[-1])
    assert int(torch.count_nonzero(out[:lo])) == 0
    assert int(torch.count_nonzero(out[hi:])) == 0
    if hi > lo:
        assert _rel_err(out, ref) <= tol


@pytest.mark.parametrize("k, p, block, dtype", [
    (64, 24, 32, torch.bfloat16),      # p not a multiple of 16
    (64, 32, 16, torch.bfloat16),      # scale block not a multiple of 32
    (64, 32, 32, torch.float32)])      # fp32 activations
def test_row9_int8_shapes_the_tile_does_not_take_raise(dev, k, p, block,
                                                       dtype):
    """The geometries the int8 GEMM refuses no longer raise: they take the
    CUDA-core int8 branch (its own launch count), the GEMM's none."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    x, wire, scale, offs, off_np = _gmmq_inputs("window", k, p, block, dtype,
                                                28)
    assert not tgm.int8_gemm_takes(dtype, k, p, wire.shape[0], block)
    before = (tgm.GROUPED_MATMUL_INT8.launches,
              tgm.GROUPED_MATMUL_INT8_SIMT.launches)
    out = tgm.grouped_matmul_quantized(x, wire, scale, offs)
    torch.cuda.synchronize()
    assert (tgm.GROUPED_MATMUL_INT8.launches,
            tgm.GROUPED_MATMUL_INT8_SIMT.launches) == (before[0],
                                                       before[1] + 1)
    ref = tgm.grouped_matmul_quantized(x, wire, scale, offs,
                                       backend="reference")
    assert out.dtype == dtype and _rel_err(out, ref) <= (
        1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("case, k, p", [("moe", 768, 3072),
                                        ("moe", 3072, 768),
                                        ("straddle", 64, 72),
                                        ("many_groups", 8, 520)])
def test_row9_both_column_tiles(dev, trans, case, k, p):
    """The 16-bit GEMM at 128- and 256-column tiles on the same inputs:
    each the plain version's result within a 16-bit rounding, rows
    outside the window zero, each deterministic."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    fn = _gmm_t_inputs if trans else _gmm_inputs
    x, w, offs, off_np = fn(case, k, p, torch.bfloat16, 46)
    wf = w.transpose(1, 2) if trans else w
    for cols in (128, 256):
        out = tgm._gmm_kernel(x, w, offs, trans=trans, cols=cols)
        again = tgm._gmm_kernel(x, w, offs, trans=trans, cols=cols)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        _check_gmm(x, wf, offs, off_np, out, 1e-2)


@pytest.mark.parametrize("branch", ["mma", "mma_t", "int8"])
@pytest.mark.parametrize("case", ["moe", "skewed"])
def test_row9_tensor_core_branches_repeat_bitwise(dev, branch, case):
    """Twenty launches of each tensor-core branch at the ragged MoE
    step's fc1 shape give the same bits: one writer per output element,
    no atomics, and no stale read of a widened int8 stage (the proxy
    fence between its writers and the wgmma that read it)."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    if branch == "int8":
        x, wire, scale, offs, _ = _gmmq_inputs(case, 768, 3072, 128,
                                               torch.bfloat16, 45)

        def call():
            return tgm.grouped_matmul_quantized(x, wire, scale, offs)
    else:
        trans = branch == "mma_t"
        fn = _gmm_t_inputs if trans else _gmm_inputs
        x, w, offs, _ = fn(case, 768, 3072, torch.bfloat16, 45)

        def call():
            return tgm._gmm_kernel(x, w, offs, trans=trans)
    first = call()
    for _ in range(20):
        assert torch.equal(call(), first)
    torch.cuda.synchronize()


def test_row9_zero_rows_launch_nothing(dev):
    """N = 0: every branch returns an empty [0, p] result in the right
    dtype without a launch (the JAX _gmm_impl's early return)."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    off = torch.zeros(5, dtype=torch.int32, device=dev)
    x = torch.zeros(0, 64, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(4, 64, 32, dtype=torch.bfloat16, device=dev)
    q = tgm.quantize_group_weights(w.float(), 32)
    before = dict(ku.launch_counts())
    outs = [tgm.grouped_matmul(x, w, off),
            tgm._gmm_route(x, w.transpose(1, 2).contiguous(), off, False,
                           trans=True),
            tgm.grouped_matmul_quantized(x, q["wire"], q["scale"], off)]
    assert ku.launch_counts() == before
    for out in outs:
        assert tuple(out.shape) == (0, 32) and out.dtype == torch.bfloat16


def test_row9_autograd_on_the_card(dev):
    """grouped_matmul's backward on CUDA bf16 tensors: dx through the
    transposed tensor-core read (one launch, no fp32 branch), dw the
    masked products; both against the plain route's autograd."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    x, w, offs, off_np = _gmm_inputs("moe_small", 64, 128, torch.bfloat16,
                                     29)
    g = torch.randn(x.shape[0], 128, device=dev,
                    generator=_gen(30)).to(torch.bfloat16)
    grads = {}
    for backend in (None, "reference"):
        xa = x.clone().requires_grad_(True)
        wa = w.clone().requires_grad_(True)
        t0 = tgm.GROUPED_MATMUL_MMA_T.launches
        f0 = tgm.GROUPED_MATMUL.launches
        out = tgm.grouped_matmul(xa, wa, offs, backend=backend)
        out.backward(g)
        torch.cuda.synchronize()
        if backend is None:
            assert tgm.GROUPED_MATMUL_MMA_T.launches == t0 + 1
            assert tgm.GROUPED_MATMUL.launches == f0
        grads[backend] = (xa.grad, wa.grad)
    (dx, dw), (rdx, rdw) = grads[None], grads["reference"]
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.bfloat16
    assert _rel_err(dx, rdx) <= 1e-2 and _rel_err(dw, rdw) <= 1e-2
    for xo, go in ((x.float(), g.float()), (x, g)):
        dw32 = tgm._grouped_dw(xo, go, offs)
        assert dw32.dtype == torch.float32
        assert _rel_err(dw32, rdw.float()) <= 1e-2


def test_row9_mma_offsets_stay_on_the_device(dev):
    """The tensor-core branch also reads its offsets on the device: a
    captured launch follows offsets changed in place."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    x, w, offs, off_np = _gmm_inputs("moe_small", 64, 64, torch.bfloat16, 31)
    static = offs.clone()
    with torch.no_grad():
        tgm.grouped_matmul(x, w, static)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = tgm.grouped_matmul(x, w, static)
        for case_off in (off_np.tolist(), [50] * 5, [0, 0, 50, 50, 50]):
            static.copy_(torch.tensor(case_off, dtype=torch.int32,
                                      device=dev))
            graph.replay()
            torch.cuda.synchronize()
            want = tgm.grouped_matmul(x, w, static.clone(),
                                      backend="reference")
            assert int(torch.count_nonzero(out[:case_off[0]])) == 0
            if case_off[0] < 50:
                assert _rel_err(out, want) <= 1e-2


def test_launch_counts_reset(dev):
    x = torch.randn(4, 64, device=dev)
    tln.fused_layer_norm(x)
    assert ku.launch_counts()["layer_norm_fwd"] >= 1
    ku.reset_launch_counts()
    assert set(ku.launch_counts().values()) == {0}


def test_spec_round_captures_and_replays_new_words(dev):
    """One speculative round (``models/speculative.spec_round``: n-gram
    drafts, a verify forward over a paged pool, the accept test and the
    correction draw) captured in a CUDA graph: replayed with other key
    words copied into the captured words tensor, it gives what an eager
    round on those words gives, bit for bit.  Mixed temperatures, so the
    draws matter."""
    from apex_tpu_torch.models.config import gpt_tiny
    from apex_tpu_torch.models.generate import init_kv_cache, prefill
    from apex_tpu_torch.models.speculative import SpecConfig, spec_round
    from apex_tpu_torch.models.transformer_lm import init_gpt_params

    cfg = gpt_tiny(num_layers=2, hidden_size=256, num_attention_heads=4,
                   vocab_size=512, max_position_embeddings=128,
                   init_method_std=0.2)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), dev)
    spec = SpecConfig(k=4)
    b, s = 4, 24
    gen = _gen(3)
    prompt = torch.randint(0, 512, (b, s), device=dev, generator=gen)
    prompt[:, s // 2:] = prompt[:, :s - s // 2]        # a repeated motif
    hist = torch.zeros(b, 64, dtype=torch.long, device=dev)
    hist[:, :s] = prompt
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    temps = torch.tensor([0.0, 0.8, 1.2, 0.0], device=dev)

    def fresh():
        cache = init_kv_cache(cfg, b, 64, cache_layout="paged", block_size=16,
                              device=dev)
        logits, cache = prefill(params, prompt, cfg, cache=cache, device=dev)
        return logits.argmax(-1), cache

    def one(cache, nxt, words):
        em, n_acc, y, new, _ = spec_round(params, cfg, cache, nxt, hist,
                                          lens, words, spec=spec,
                                          temperature=temps, top_k=50)
        return em, n_acc, y, new["pos"]

    nxt, cache = fresh()
    words = torch.tensor([11, 12], dtype=torch.int64, device=dev)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        one(dict(cache), nxt, words)                  # warm up
    torch.cuda.current_stream(dev).wait_stream(stream)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = one(dict(cache), nxt, words)
    for w in ((11, 12), (0xDEADBEEF, 5), (7, 7)):
        words.copy_(torch.tensor(w, dtype=torch.int64))
        graph.replay()
        got = [t.clone() for t in captured]
        _, cache_e = fresh()
        want = one(cache_e, nxt, torch.tensor(w, dtype=torch.int64,
                                             device=dev))
        torch.cuda.synchronize(dev)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_), w
        # greedy rows accept only the target argmax: their emission is
        # the same under every key
        if w == (11, 12):
            greedy = got[0][[0, 3]]
        else:
            assert torch.equal(got[0][[0, 3]], greedy)



# ---------------------------------------------------------------------------
# slice 15: row 9's CUDA-core int8 branch, attention dropout and segment ids
# in rows 3, 4a, 4b and 5, and the wide-head branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2),
                                        (torch.float16, 2e-3)])
@pytest.mark.parametrize("k, p, block", [(768, 3072, 128), (96, 40, 48),
                                         (64, 40, 32), (384, 24, 48)])
@pytest.mark.parametrize("case", ["moe_small", "empty_groups", "window",
                                  "all_outside", "many_groups", "straddle"])
def test_row9_int8_simt_branch(dev, dtype, tol, k, p, block, case):
    """Row 9's CUDA-core int8 branch against the plain version (the slab
    dequantized to fp32): fp32 x, scale blocks of 48, p of 40 and 24,
    windows, empty groups, G = 70; one launch, zeros outside the window."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    x, wire, scale, offs, off_np = _gmmq_inputs(case, k, p, block, dtype, 29)
    if tgm.int8_gemm_takes(dtype, k, p, wire.shape[0], block):
        pytest.skip("the tensor-core GEMM takes this geometry")
    before = tgm.GROUPED_MATMUL_INT8_SIMT.launches
    out = tgm.grouped_matmul_quantized(x, wire, scale, offs)
    torch.cuda.synchronize()
    assert tgm.GROUPED_MATMUL_INT8_SIMT.launches == before + 1
    ref = tgm.grouped_matmul_quantized(x, wire, scale, offs,
                                       backend="reference")
    assert out.dtype == dtype == ref.dtype and out.shape == ref.shape
    lo, hi = int(off_np[0]), int(off_np[-1])
    assert int(torch.count_nonzero(out[:lo])) == 0
    assert int(torch.count_nonzero(out[hi:])) == 0
    if hi > lo:
        assert _rel_err(out, ref) <= tol


def test_row9_int8_simt_past_the_gemm_groups(dev):
    """More than MAX_TILE_GROUPS groups of an int8 slab: the CUDA-core
    branch, one launch."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    gn = tgm.MAX_TILE_GROUPS + 52
    gen = _gen(31)
    off = torch.sort(torch.randint(0, 3000, (gn + 1,), device=dev,
                                   generator=gen)).values.to(torch.int32)
    x = torch.randn(3000, 64, device=dev, generator=gen).bfloat16()
    q = tgm.quantize_group_weights(
        torch.randn(gn, 64, 32, device=dev, generator=gen) * 0.1, 32)
    before = tgm.GROUPED_MATMUL_INT8_SIMT.launches
    out = tgm.grouped_matmul_quantized(x, q["wire"], q["scale"], off)
    torch.cuda.synchronize()
    assert tgm.GROUPED_MATMUL_INT8_SIMT.launches == before + 1
    ref = tgm.grouped_matmul_quantized(x, q["wire"], q["scale"], off,
                                       backend="reference")
    assert _rel_err(out, ref) <= 1e-2


_FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}


def _segments(b, s, seed):
    """[b, s] int32 ids: documents of random lengths, the last row's tail
    padding (-1)."""
    g = torch.Generator().manual_seed(seed)
    rows = []
    for i in range(b):
        ids, pos, doc = [], 0, 0
        end = s - (s // 5 if i == b - 1 else 0)
        while pos < end:
            n = min(int(torch.randint(1, max(2, s // 3), (1,),
                                      generator=g)), end - pos)
            ids += [doc] * n
            pos, doc = pos + n, doc + 1
        rows.append(ids + [-1] * (s - end))
    return torch.tensor(rows, dtype=torch.int32)


def _seed(words):
    return tfa.seed_from_key(torch.tensor(words, dtype=torch.int64,
                                          device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("feature", ["dropout", "segments", "both"])
@pytest.mark.parametrize("s, n, g, d, causal, padded", [
    (130, 4, 2, 64, True, True), (300, 4, 4, 64, False, True),
    (512, 8, 2, 128, True, False), (200, 4, 1, 40, False, False),
    (600, 4, 2, 64, True, True), (1030, 4, 4, 128, False, True),
    (700, 8, 1, 32, True, False)])
def test_flash_dropout_segments(dev, dtype, feature, s, n, g, d, causal,
                                padded):
    """K2 forward and the backward route (row 5 up to 512 keys, else K6 +
    K7) with dropout, segment ids or both, against the plain versions on
    the same seed and ids: the masks are the same bits, so the tolerance
    is the dropout-free one times 1 / (1 - p).  Up to 512 keys the split
    pair, launched directly, agrees too."""
    b, p = 3, 0.2
    q, k, v, do = _flash_inputs(dtype, b, s, n, g, d, seed=41)
    kpm = None
    if padded:
        lens = torch.tensor([s, s // 2 + 5, s - 3], device=dev)
        kpm = torch.arange(s, device=dev)[None] >= lens[:, None]
    kw = dict(causal=causal, key_padding_mask=kpm)
    if feature in ("dropout", "both"):
        kw.update(dropout_p=p, seed=_seed([3, 0xDEADBEEF]))
    if feature in ("segments", "both"):
        kw["segment_ids"] = _segments(b, s, s).to(dev)
    scale = 1.0 / (1.0 - p) if "seed" in kw else 1.0
    before = ku.launch_counts()
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    after = ku.launch_counts()
    short = s <= tfa.SHORT_KEYS_MAX
    assert after["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert after["flash_attention_bwd_short"] == \
        before["flash_attention_bwd_short"] + int(short)
    assert after["flash_attention_bwd_dq"] == \
        before["flash_attention_bwd_dq"] + int(not short)
    ref, ref_lse = tfa.flash_attention_fwd_ref(q, k, v, **kw)
    assert _rel_err(o, ref) <= _FWD_TOL[dtype] * scale * 2
    live = ref_lse > -1e29
    assert torch.equal(lse > -1e29, live)
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3,
                               rtol=1e-4)
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for a, e, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == dtype and a.shape == e.shape, name
        assert torch.isfinite(a.float()).all(), name
        assert _rel_err(a, e) <= _BWD_TOL[dtype] * scale, name
    if short:
        ops = tfa.flash_bwd_operands(q, k, v, o, lse, do, **{
            key: val for key, val in kw.items() if key != "causal"})
        split = (tfa.flash_bwd_dq(ops, causal=causal),
                 *tfa.flash_bwd_dkv(ops, causal=causal))
        for a, e, name in zip(split, want, ("dq", "dk", "dv")):
            assert _rel_err(a, e) <= _BWD_TOL[dtype] * scale, name


def test_flash_dropout_masks_follow_the_seed_and_replay(dev):
    """The same seed gives the same bits, another seed other ones; a call
    captured in a CUDA graph reads its seed on the device, so a copy of
    new key words replays the new mask, as an eager call draws it."""
    q, k, v, do = _flash_inputs(torch.bfloat16, 2, 600, 8, 2, 64, seed=43)
    seed = _seed([1, 2])
    a = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_p=0.1,
                                seed=seed)[0]
    b_ = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_p=0.1,
                                 seed=seed)[0]
    c = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_p=0.1,
                                seed=_seed([1, 3]))[0]
    assert torch.equal(a, b_) and not torch.equal(a, c)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        tfa.flash_attention_fwd(q, k, v, causal=True, dropout_p=0.1,
                                seed=seed)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tfa.flash_attention_fwd(q, k, v, causal=True,
                                           dropout_p=0.1, seed=seed)[0]
    seed.copy_(_seed([1, 3]))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, c)


def test_flash_packed_matches_per_document(dev):
    """flash_attention_packed (K2 with segment ids; K6 + K7 past 512 keys)
    against one flash_attention call per document on its own rows,
    forward and gradients, bf16 causal GQA; padding rows get no
    gradient."""
    lens = [300, 700, 64, 400]
    total = sum(lens) + 36
    n, g, d = 8, 2, 64
    gen = _gen(45)
    q = torch.randn(total, n, d, device=dev, generator=gen).bfloat16()
    k = torch.randn(total, g, d, device=dev, generator=gen).bfloat16()
    v = torch.randn(total, g, d, device=dev, generator=gen).bfloat16()
    do = torch.randn(total, n, d, device=dev, generator=gen).bfloat16()
    cu = torch.tensor([0] + list(torch.tensor(lens).cumsum(0)),
                      dtype=torch.int32, device=dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention_packed(*leaves, cu, causal=True)
    out.backward(do)
    start = 0
    for L in lens:
        sl = slice(start, start + L)
        parts = [t[sl][None].clone().requires_grad_() for t in (q, k, v)]
        want = tfa.flash_attention(*parts, causal=True)
        want.backward(do[sl][None])
        assert _rel_err(out[sl], want[0]) <= 2e-2
        for leaf, part in zip(leaves, parts):
            assert _rel_err(leaf.grad[sl], part.grad[0]) <= 2e-2
        start += L
    assert all(torch.count_nonzero(t.grad[start:]) == 0 for t in leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [160, 256, 320])
@pytest.mark.parametrize("s, n, g, causal, padded, feature", [
    (130, 4, 2, True, True, None), (300, 4, 4, False, True, None),
    (600, 4, 1, True, False, "dropout"), (200, 4, 2, True, True, "both")])
def test_flash_wide_heads(dev, dtype, d, s, n, g, causal, padded, feature):
    """Head sizes above 128: the wide forward, dq and dk/dv kernels (one
    launch each, whatever the key length) against the plain versions."""
    b, p = 2, 0.2
    q, k, v, do = _flash_inputs(dtype, b, s, n, g, d, seed=47)
    kpm = None
    if padded:
        lens = torch.tensor([s, s // 2 + 1], device=dev)
        kpm = torch.arange(s, device=dev)[None] >= lens[:, None]
    kw = dict(causal=causal, key_padding_mask=kpm)
    if feature in ("dropout", "both"):
        kw.update(dropout_p=p, seed=_seed([5, 6]))
    if feature == "both":
        kw["segment_ids"] = _segments(b, s, 7).to(dev)
    scale = 1.0 / (1.0 - p) if "seed" in kw else 1.0
    before = ku.launch_counts()
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    after = ku.launch_counts()
    for name in ("flash_attention_fwd_wide", "flash_attention_bwd_dq_wide",
                 "flash_attention_bwd_dkv_wide"):
        assert after[name] == before[name] + 1, name
    for name in ("flash_attention_fwd", "flash_attention_bwd_short",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name], name
    ref, ref_lse = tfa.flash_attention_fwd_ref(q, k, v, **kw)
    assert _rel_err(o, ref) <= _FWD_TOL[dtype] * scale * 2
    live = ref_lse > -1e29
    assert torch.equal(lse > -1e29, live)
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3,
                               rtol=1e-4)
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for a, e, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == dtype and a.shape == e.shape, name
        assert _rel_err(a, e) <= _BWD_TOL[dtype] * scale, name


# ---- M1-M4: the multi-tensor kernels (csrc/multi_tensor.cu) ----

_MT_SIZES = (0, 1, 3, 4099, 65536, 65541, 200003)   # empty, odd, chunk edges


def _mt_list(dev, dtype, seed, sizes=_MT_SIZES, scale=1.0):
    g = _gen(seed)
    return [(torch.randn(n, device=dev, generator=g) * scale).to(dtype)
            for n in sizes]


def _mt_launches(kernel, fn):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    return out, kernel.launches - before


@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_mt_scale_matches_plain(dev, src_dtype, out_dtype):
    """M1 over odd, empty and multi-chunk tensors, a device scale: one
    launch, the plain version's values bit for bit, bitwise repeats."""
    from apex_tpu_torch.multi_tensor import multi_tensor_apply as mta

    xs = _mt_list(dev, src_dtype, 1, scale=300.0)
    s = torch.tensor(1.0 / 4096, device=dev)
    dts = [out_dtype] * len(xs)
    (outs, flag), n = _mt_launches(
        mta.MT_SCALE, lambda: mta.multi_tensor_scale(xs, s, out_dtypes=dts))
    assert n == 1 and int(flag) == 0
    ref, rflag = mta.multi_tensor_scale(xs, s, out_dtypes=dts,
                                        backend="reference")
    again, _ = mta.multi_tensor_scale(xs, s, out_dtypes=dts)
    for a, b, c in zip(outs, ref, again):
        assert a.dtype == out_dtype and a.shape == b.shape
        assert torch.equal(a, b) and torch.equal(a, c)


def test_mt_scale_flag_and_noop(dev):
    """An inf or a nan in any tensor sets the flag; a set incoming flag
    passes the sources through unscaled and is OR'ed in."""
    from apex_tpu_torch.multi_tensor import multi_tensor_scale

    for bad in (float("inf"), float("nan"), -float("inf")):
        xs = _mt_list(dev, torch.float16, 2)
        xs[5][65540] = bad
        _, flag = multi_tensor_scale(xs, 0.5)
        assert int(flag) == 1
    xs = _mt_list(dev, torch.bfloat16, 3)
    noop = torch.ones((), dtype=torch.int32, device=dev)
    outs, flag = multi_tensor_scale(xs, 0.5, noop_flag=noop,
                                    out_dtypes=[torch.float32] * len(xs))
    assert int(flag) == 1
    assert all(torch.equal(o, x.float()) for o, x in zip(outs, xs))


def test_mt_axpby_mixed_dtypes(dev):
    """M1's axpby mode: x bf16, y fp32 (and the reverse), out fp32, one
    launch, bit for bit the plain version; a nan in y sets the flag."""
    from apex_tpu_torch.multi_tensor import multi_tensor_apply as mta

    xs = _mt_list(dev, torch.bfloat16, 4)
    ys = _mt_list(dev, torch.float32, 5)
    dts = [torch.float32] * len(xs)
    for a, b in ((xs, ys), (ys, xs)):
        (outs, flag), n = _mt_launches(
            mta.MT_SCALE,
            lambda: mta.multi_tensor_axpby(a, b, 2.0, 0.5, out_dtypes=dts))
        ref, _ = mta.multi_tensor_axpby(a, b, 2.0, 0.5, out_dtypes=dts,
                                        backend="reference")
        assert n == 1 and int(flag) == 0
        assert all(torch.equal(o, r) for o, r in zip(outs, ref))
    ys[3][7] = float("nan")
    assert int(mta.multi_tensor_axpby(xs, ys, 1.0, 1.0)[1]) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mt_l2norm_matches_plain(dev, dtype):
    """M2: per-tensor and global norms within 1e-6 of the plain version,
    bitwise repeats, one launch a call whatever the tensor count."""
    from apex_tpu_torch.multi_tensor import multi_tensor_apply as mta

    xs = _mt_list(dev, dtype, 6)
    (total, per), n = _mt_launches(
        mta.MT_L2NORM, lambda: mta.multi_tensor_l2norm(xs, per_tensor=True))
    rt, rp = mta.multi_tensor_l2norm(xs, per_tensor=True, backend="reference")
    assert n == 1
    torch.testing.assert_close(total, rt, rtol=1e-6, atol=0)
    torch.testing.assert_close(per, rp, rtol=1e-6, atol=0)
    t2, p2 = mta.multi_tensor_l2norm(xs, per_tensor=True)
    assert torch.equal(total, t2) and torch.equal(per, p2)
    many = _mt_list(dev, dtype, 7, sizes=[5, 70000, 0] * 40)
    _, n = _mt_launches(mta.MT_L2NORM,
                        lambda: mta.multi_tensor_l2norm(many))
    assert n == 1
    empty, _ = mta.multi_tensor_l2norm([])
    assert float(empty) == 0.0


def _adam_case(dev, p_dtype, g_dtype, seed):
    sizes = _MT_SIZES
    g = _gen(seed)
    ps = [(torch.randn(n, device=dev, generator=g) * 0.1).to(p_dtype)
          for n in sizes]
    gs = [(torch.randn(n, device=dev, generator=g) * 0.01).to(g_dtype)
          for n in sizes]
    ms = [torch.randn(n, device=dev, generator=g) * 1e-3 for n in sizes]
    vs = [torch.rand(n, device=dev, generator=g) * 1e-5 for n in sizes]
    return gs, ps, ms, vs


def _bc(dev, beta, step):
    t = torch.tensor(float(step), device=dev)
    return 1.0 - torch.pow(torch.full_like(t, beta), t)


def _max_rel(a, b) -> float:
    """max |a - b| over max |b| (0 for empty tensors)."""
    if b.numel() == 0:
        return 0.0
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def _assert_out_close(out, ref, rtol):
    """Every output within ``rtol`` of the plain version, relative to the
    tensor's largest value: an element that is a near-cancelling sum
    (LAMB's m̂/d + wd·p, a moment near 0) moves far relative to itself
    when one operand moves by an ulp."""
    for a_list, b_list in zip(out[:3], ref[:3]):
        for a, b in zip(a_list, b_list):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert _max_rel(a, b) <= rtol
    for a, b in zip(out.model, ref.model):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and _max_rel(a, b) <= rtol


@pytest.mark.parametrize("adam_w_mode, wd", [(True, 0.01), (False, 0.01),
                                             (True, 0.0)])
@pytest.mark.parametrize("p_dtype, g_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float16)])
def test_mt_adam_matches_plain(dev, adam_w_mode, wd, p_dtype, g_dtype):
    """M3 in update and apply mode (with bf16 model copies and a device
    lr) against the plain version within 1e-6 relative; one launch;
    bitwise repeats; update_norm from the kernel's partial sums."""
    from apex_tpu_torch.multi_tensor import multi_tensor_apply as mta

    gs, ps, ms, vs = _adam_case(dev, p_dtype, g_dtype, 8)
    kw = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=wd,
              adam_w_mode=adam_w_mode, bc1=_bc(dev, 0.9, 3),
              bc2=_bc(dev, 0.999, 3))
    for apply, lr in ((False, 1e-3), (True, torch.tensor(2e-3, device=dev))):
        extra = dict(apply=apply, update_norm=True, lr=lr,
                     overflow=torch.zeros((), dtype=torch.bool, device=dev),
                     model_dtypes=[torch.bfloat16] * len(ps)
                     if apply else None)
        out, n = _mt_launches(mta.MT_ADAM, lambda: mta.multi_tensor_adam(
            gs, ps, ms, vs, **kw, **extra))
        ref = mta.multi_tensor_adam(gs, ps, ms, vs, backend="reference",
                                    **kw, **extra)
        assert n == 1
        _assert_out_close(out, ref, 1e-6)
        torch.testing.assert_close(out.update_sq, ref.update_sq, rtol=1e-5,
                                   atol=0)
        again = mta.multi_tensor_adam(gs, ps, ms, vs, **kw, **extra)
        for a_list, b_list in zip(out[:3], again[:3]):
            assert all(torch.equal(a, b) for a, b in zip(a_list, b_list))


@pytest.mark.parametrize("which", ["adam", "lamb"])
def test_mt_overflow_keeps_every_bit(dev, which):
    """Apply mode with the overflow flag set (an inf planted in one
    gradient): p, m and v come back bit for bit, the model copy is p
    cast."""
    from apex_tpu_torch.multi_tensor import multi_tensor_apply as mta

    gs, ps, ms, vs = _adam_case(dev, torch.float32, torch.float32, 9)
    gs[4][3] = float("inf")
    flag = mta.multi_tensor_scale(gs, 1.0)[1] != 0
    kw = dict(betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
              adam_w_mode=True, lr=1e-3, apply=True, overflow=flag,
              model_dtypes=[torch.float16] * len(ps))
    if which == "adam":
        out = mta.multi_tensor_adam(gs, ps, ms, vs, **kw)
    else:
        out = mta.multi_tensor_lamb(gs, ps, ms, vs, beta3=0.1,
                                    use_ratio=True, **kw)
    for new, old in zip(out.params + out.exp_avg + out.exp_avg_sq,
                        ps + ms + vs):
        assert torch.equal(new, old)
    assert all(torch.equal(mo, p.half()) for mo, p in zip(out.model, ps))


@pytest.mark.parametrize("use_ratio, clip", [(True, 2.5), (False, None),
                                             (True, None)])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_mt_lamb_matches_plain(dev, use_ratio, clip, adam_w_mode):
    """M4's two stages in update and apply mode against the plain version
    (the trust ratios' sums in another order: 1e-6 relative); one call of
    the entry; bitwise repeats."""
    from apex_tpu_torch.multi_tensor import multi_tensor_apply as mta

    gs, ps, ms, vs = _adam_case(dev, torch.float32, torch.bfloat16, 10)
    kw = dict(betas=(0.9, 0.999), beta3=0.1, eps=1e-6, weight_decay=0.01,
              adam_w_mode=adam_w_mode, use_ratio=use_ratio, lr=1e-3,
              bc1=_bc(dev, 0.9, 2), bc2=_bc(dev, 0.999, 2),
              clip=None if clip is None else torch.tensor(clip, device=dev))
    for apply in (False, True):
        extra = dict(apply=apply, model_dtypes=[torch.bfloat16] * len(ps)
                     if apply else None)
        out, n = _mt_launches(mta.MT_LAMB, lambda: mta.multi_tensor_lamb(
            gs, ps, ms, vs, **kw, **extra))
        assert n == 1
        ref = mta.multi_tensor_lamb(gs, ps, ms, vs, backend="reference",
                                    **kw, **extra)
        _assert_out_close(out, ref, 1e-6)
        again = mta.multi_tensor_lamb(gs, ps, ms, vs, **kw, **extra)
        for a_list, b_list in zip(out[:3], again[:3]):
            assert all(torch.equal(a, b) for a, b in zip(a_list, b_list))


def test_mt_unaligned_views_and_launch_count(dev):
    """Tensors at odd element offsets take the element-by-element walk and
    still match; 3 tensors and 120 take one launch each."""
    from apex_tpu_torch.multi_tensor import multi_tensor_apply as mta

    base = torch.randn(300001, device=dev, generator=_gen(11))
    xs = [base[1:70001], base[70003:70010], base[70011:]]
    outs, _ = mta.multi_tensor_scale(xs, 3.0)
    ref, _ = mta.multi_tensor_scale(xs, 3.0, backend="reference")
    assert all(torch.equal(a, b) for a, b in zip(outs, ref))
    for count in (3, 120):
        many = _mt_list(dev, torch.float32, 12, sizes=[1000] * count)
        _, n = _mt_launches(mta.MT_SCALE,
                            lambda: mta.multi_tensor_scale(many, 2.0))
        assert n == 1


def test_mt_many_tensors_launch_per_group(dev):
    """A list of 700 tensors (odd, empty and multi-chunk; mixed dtypes)
    takes ceil(700 / MAX_TENSORS) = 3 calls of each kernel's entry, and
    M1-M4 still match their plain versions: M1 and M3 bit for bit, the
    norms and M4 within 1e-6 relative; the flag of an inf in the last
    group; bitwise repeats of the norms."""
    from apex_tpu_torch.multi_tensor import multi_tensor_apply as mta

    count = 700
    groups = -(-count // mta.MAX_TENSORS)
    sizes = [(0, 1, 3, 4099, 65541)[i % 5] + i for i in range(count)]
    g = _gen(14)
    ps = [torch.randn(n, device=dev, generator=g) * 0.1 for n in sizes]
    gs = [(torch.randn(n, device=dev, generator=g) * 0.01).to(
        (torch.float32, torch.bfloat16)[i % 2]) for i, n in enumerate(sizes)]
    ms = [torch.randn(n, device=dev, generator=g) * 1e-3 for n in sizes]
    vs = [torch.rand(n, device=dev, generator=g) * 1e-5 for n in sizes]
    f32 = [torch.float32] * count

    (outs, flag), n = _mt_launches(
        mta.MT_SCALE, lambda: mta.multi_tensor_scale(gs, 0.25, out_dtypes=f32))
    ref, _ = mta.multi_tensor_scale(gs, 0.25, out_dtypes=f32,
                                    backend="reference")
    assert n == groups and int(flag) == 0
    assert all(torch.equal(a, b) for a, b in zip(outs, ref))
    (sums, _), n = _mt_launches(
        mta.MT_SCALE, lambda: mta.multi_tensor_axpby(gs, ps, 2.0, 0.5,
                                                     out_dtypes=f32))
    ref, _ = mta.multi_tensor_axpby(gs, ps, 2.0, 0.5, out_dtypes=f32,
                                    backend="reference")
    assert n == groups and all(torch.equal(a, b) for a, b in zip(sums, ref))
    bad = [x.clone() for x in gs]
    bad[count - 2][5] = float("inf")
    assert int(mta.multi_tensor_scale(bad, 1.0)[1]) == 1

    (total, per), n = _mt_launches(
        mta.MT_L2NORM, lambda: mta.multi_tensor_l2norm(gs, per_tensor=True))
    rt, rp = mta.multi_tensor_l2norm(gs, per_tensor=True, backend="reference")
    assert n == groups and per.shape == (count,)
    torch.testing.assert_close(total, rt, rtol=1e-6, atol=0)
    torch.testing.assert_close(per, rp, rtol=1e-6, atol=0)
    t2, p2 = mta.multi_tensor_l2norm(gs, per_tensor=True)
    assert torch.equal(total, t2) and torch.equal(per, p2)

    kw = dict(betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
              adam_w_mode=True, lr=1e-3, bc1=_bc(dev, 0.9, 2),
              bc2=_bc(dev, 0.999, 2), apply=True, update_norm=True,
              overflow=torch.zeros((), dtype=torch.bool, device=dev),
              model_dtypes=[torch.bfloat16] * count)
    out, n = _mt_launches(mta.MT_ADAM,
                          lambda: mta.multi_tensor_adam(gs, ps, ms, vs, **kw))
    want = mta.multi_tensor_adam(gs, ps, ms, vs, backend="reference", **kw)
    assert n == groups
    _assert_out_close(out, want, 1e-6)
    torch.testing.assert_close(out.update_sq, want.update_sq, rtol=1e-5,
                               atol=0)
    out, n = _mt_launches(mta.MT_LAMB, lambda: mta.multi_tensor_lamb(
        gs, ps, ms, vs, beta3=0.1, use_ratio=True, **kw))
    want = mta.multi_tensor_lamb(gs, ps, ms, vs, beta3=0.1, use_ratio=True,
                                 backend="reference", **kw)
    assert n == groups
    _assert_out_close(out, want, 1e-6)


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_mt_adam_kernel_flat_reads_device_scalars(dev, adam_w_mode):
    """ops.flat_adam.adam_kernel_flat on the card (M3 reading lr, the
    bias corrections and mt::Hyper from device memory) against its plain
    version on the same device, within 1e-6 relative; one launch."""
    from apex_tpu_torch.multi_tensor import multi_tensor_apply as mta
    from apex_tpu_torch.ops.flat_adam import adam_kernel_flat

    g = _gen(15)
    n = 200003
    gr, p = (torch.randn(n, device=dev, generator=g) * s
             for s in (0.01, 0.1))
    m = torch.randn(n, device=dev, generator=g) * 1e-3
    v = torch.rand(n, device=dev, generator=g) * 1e-5
    scalars = torch.stack([torch.tensor(x, device=dev) for x in (
        2e-3, 0.9, 0.999, 1e-8, 0.01)] + [_bc(dev, 0.9, 3),
                                          _bc(dev, 0.999, 3)]).float()
    got, launches = _mt_launches(mta.MT_ADAM, lambda: adam_kernel_flat(
        gr, p, m, v, scalars, adam_w_mode))
    want = adam_kernel_flat(gr, p, m, v, scalars, adam_w_mode,
                            backend="reference")
    assert launches == 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and _max_rel(a, b) <= 1e-6


def test_mt_fused_optimizers_on_trees(dev):
    """fused_adam and fused_lamb over a tree with an int leaf and an empty
    leaf: the update on the card against the CPU's plain version; the int
    leaf passes through."""
    from apex_tpu_torch.optimizers import fused_adam, fused_lamb

    g = _gen(13)
    params = {"w": torch.randn(70001, device=dev, generator=g),
              "e": torch.zeros(0, device=dev),
              "i": torch.arange(5, device=dev),
              "s": {"b": torch.randn(3, 5, device=dev, generator=g)}}
    grads = {k: (v if not v.is_floating_point() else v * 0.1)
             for k, v in params.items() if k != "s"}
    grads["s"] = {"b": params["s"]["b"] * 0.2}
    cpu = lambda t: {k: cpu(v) if isinstance(v, dict) else v.cpu()  # noqa: E731
                     for k, v in t.items()}
    for tx in (fused_adam(lr=1e-3, weight_decay=0.01),
               fused_lamb(lr=1e-3)):
        u, s = tx.update(grads, tx.init(params), params)
        ru, rs = tx.update(cpu(grads), tx.init(cpu(params)), cpu(params))
        assert torch.equal(u["i"], params["i"])
        assert u["e"].shape == (0,)
        for k in ("w",):
            torch.testing.assert_close(u[k].cpu(), ru[k], rtol=1e-5,
                                       atol=1e-9)
        torch.testing.assert_close(u["s"]["b"].cpu(), ru["s"]["b"],
                                   rtol=1e-5, atol=1e-9)


# --- single-device training, complete --------------------------------------


def _gpt_steps(cfg, dev, steps=2, seed=0, level="O2"):
    """``steps`` steps at ``level`` of a GPT config from one seeded state:
    (losses, final state, launches of the first step)."""
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.optimizers import fused_adam

    init, step = make_gpt_train_step(cfg, fused_adam(lr=1e-3), level,
                                     device=dev)
    state = init(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    losses, first = [], None
    for i in range(steps):
        tok = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
        torch.cuda.synchronize()
        ku.reset_launch_counts()
        state, m = step(state, tok.to(dev), tok.to(dev))
        torch.cuda.synchronize()
        first = first or ku.launch_counts()
        losses.append(m["loss"])
    return losses, state, first


def _bitwise_trees(a, b):
    from apex_tpu_torch.optimizers._common import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.reshape(-1).view(torch.uint8),
                    y.reshape(-1).view(torch.uint8)) for x, y in zip(la, lb))


@pytest.mark.parametrize("extra, level", [
    ({}, "O2"), ({"num_experts": 4, "moe_routing": "ragged"}, "O2"),
    ({}, "O1")],
    ids=["dense", "moe_ragged", "dense_o1"])
def test_remat_is_bitwise_no_remat_on_the_card(dev, extra, level):
    """A remat step on the kernel path equals the step without remat bit
    for bit (losses, masters, moments), and launches the recompute's K1
    and K2 once more a layer.  Under O1 the recompute runs on autograd's
    device thread, which re-enters the forward's per-thread
    ``amp_patch_scope``: its casts must repeat the forward's."""
    import dataclasses

    from apex_tpu_torch.models.config import gpt_tiny

    base = gpt_tiny(num_layers=3, hidden_size=128, num_attention_heads=2,
                    vocab_size=512, max_position_embeddings=256,
                    fused_head_ce=True, **extra)
    l0, s0, c0 = _gpt_steps(dataclasses.replace(base, remat=False), dev,
                            steps=3, level=level)
    l1, s1, c1 = _gpt_steps(dataclasses.replace(base, remat=True), dev,
                            steps=3, level=level)
    for a, b in zip(l0, l1):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert _bitwise_trees(s0.master_params, s1.master_params)
    assert _bitwise_trees(s0.opt_state, s1.opt_state)
    L = base.num_layers
    assert c1["layer_norm_fwd"] == c0["layer_norm_fwd"] + 2 * L
    assert c1["flash_attention_fwd"] == c0["flash_attention_fwd"] + L
    assert c1["layer_norm_bwd"] == c0["layer_norm_bwd"] == 2 * L + 1


def test_remat_with_dropout_is_bitwise_on_the_card(dev):
    """The recompute redraws every dropout mask from the same key words:
    a remat step with dropout equals the step without remat bit for
    bit."""
    import dataclasses

    from apex_tpu_torch.models.config import gpt_tiny
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.utils import prng

    base = gpt_tiny(num_layers=2, hidden_size=128, num_attention_heads=2,
                    vocab_size=512, max_position_embeddings=256,
                    hidden_dropout=0.1, attention_dropout=0.1,
                    drop_path_rate=0.1, fused_head_ce=True)
    tok = torch.randint(0, 512, (2, 256),
                        generator=torch.Generator().manual_seed(3)).to(dev)
    got = []
    for remat in (False, True):
        init, step = make_gpt_train_step(
            dataclasses.replace(base, remat=remat), fused_adam(lr=1e-3),
            "O2", device=dev)
        state = init(torch.Generator().manual_seed(0))
        for i in range(2):
            state, m = step(state, tok, tok, prng.key(7 + i, dev))
        got.append((m["loss"], state))
    assert torch.equal(got[0][0].view(torch.int32),
                       got[1][0].view(torch.int32))
    assert _bitwise_trees(got[0][1].master_params, got[1][1].master_params)


@pytest.mark.parametrize("rows, hidden", [(16384, 768), (8192, 1024),
                                          (300, 100)])
@pytest.mark.parametrize("rms", [False, True])
def test_k5_memory_efficient_matches_plain(dev, rows, hidden, rms):
    """memory_efficient=True: x rebuilt from y in front of K5, on the card
    against the same path's plain version (K1 and K5 once each), also
    with zero scales (the clamp), and against the default mode's
    gradients where no scale is zero."""
    g = _gen(17)
    x = (torch.randn(rows, hidden, device=dev, generator=g) * 2).bfloat16()
    w0 = 1 + 0.1 * torch.randn(hidden, device=dev, generator=g)
    b = None if rms else 0.1 * torch.randn(hidden, device=dev, generator=g)
    dy = torch.randn(rows, hidden, device=dev, generator=g).bfloat16()
    zero = w0.clone()
    zero[::13] = 0.0          # the rebuild's clamp (x is lost in those
    #                           columns, so only kernel vs plain there)
    for w, modes in ((zero, (True,)), (w0, (True, False))):
        _k5_me_case(x, w, b, dy, rms, modes)


def _k5_me_case(x, w, b, dy, rms, modes):
    out = {}
    for backend in (None, "reference"):
        for me in modes:
            leaves = [t.detach().clone().requires_grad_() if t is not None
                      else None for t in (x, w, b)]
            ku.reset_launch_counts()
            if rms:
                y = tln.fused_rms_norm(leaves[0], leaves[1],
                                       memory_efficient=me, backend=backend)
            else:
                y = tln.fused_layer_norm(*leaves, memory_efficient=me,
                                         backend=backend)
            y.backward(dy)
            torch.cuda.synchronize()
            counts = ku.launch_counts()
            if backend is None:
                assert counts["layer_norm_fwd"] == 1
                assert counts["layer_norm_bwd"] == 1
            out[backend, me] = [t.grad for t in leaves if t is not None]
    for a, e in zip(out[None, True], out["reference", True]):
        assert float((a.float() - e.float()).abs().max()) <= \
            2e-2 * float(e.float().abs().max())
    if False in modes:
        for a, e in zip(out[None, True], out[None, False]):
            assert float((a.float() - e.float()).abs().max()) <= \
                2e-2 * float(e.float().abs().max())


@pytest.mark.parametrize("trans", [False, True], ids=["forward", "dx"])
def test_row9_at_the_swiglu_2f_fc1(dev, trans):
    """Row 9's 16-bit branch at the swiglu experts' 2f-wide fc1 ([4096,
    768] x [8, 768, 6144], and the transposed read of its dx) against the
    plain version."""
    from apex_tpu_torch.ops import grouped_matmul as tgm

    g = _gen(19)
    loads = [700, 300, 0, 900, 512, 1024, 260, 400]
    off = torch.tensor([0] + list(torch.tensor(loads).cumsum(0)),
                       dtype=torch.int32, device=dev)
    n, k, f2 = int(off[-1]), 768, 6144
    w = (torch.randn(8, k, f2, device=dev, generator=g) * 0.02).bfloat16()
    a = torch.randn(n, f2 if trans else k, device=dev,
                    generator=g).bfloat16()
    name = "grouped_matmul_mma_t" if trans else "grouped_matmul_mma"
    before = ku.KERNELS[name].launches
    got = tgm._gmm_route(a, w, off, False, trans=trans)
    torch.cuda.synchronize()
    assert ku.KERNELS[name].launches == before + 1
    want = tgm.grouped_matmul_reference(a, w.transpose(1, 2) if trans else w,
                                        off)
    assert float((got.float() - want.float()).abs().max()) <= \
        1e-2 * float(want.float().abs().max())
