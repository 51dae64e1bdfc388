"""The port's hand-written CUDA kernels K1–K7 against their plain PyTorch
versions, on the card.  Marked ``cuda``: they skip where there is no
CUDA device.  This file imports no JAX, so on a GPU machine without JAX
it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import pytest
import torch

from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.ops import decode_step as tds
from apex_tpu_torch.ops import flash_attention as tfa
from apex_tpu_torch.ops import fused_sampling as tfs
from apex_tpu_torch.ops import layer_norm as tln

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
@pytest.mark.parametrize("hidden", [768, 100, 4096])   # vector / scalar path
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


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2),
                                        (torch.float16, 2e-3)])
@pytest.mark.parametrize("n, g, causal, padded, d", [
    (4, 4, True, False, 64), (4, 4, True, True, 64), (4, 4, False, True, 64),
    (12, 4, True, True, 64), (4, 2, True, True, 128), (4, 4, True, True, 32)])
def test_k2_flash_attention(dev, dtype, tol, n, g, causal, padded, d):
    gen = _gen(1)
    b, s = 3, 130
    q = torch.randn(b, s, n, d, device=dev, generator=gen).to(dtype)
    k = torch.randn(b, s, g, d, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, s, g, d, device=dev, generator=gen).to(dtype)
    kpm = None
    if padded:
        lens = torch.tensor([130, 77, 5], device=dev)
        kpm = torch.arange(s, device=dev)[None] >= lens[:, None]
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                     key_padding_mask=kpm)
    ref = tfa.mha_reference(q, k, v, causal=causal, key_padding_mask=kpm)
    torch.testing.assert_close(o.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("nh, g, rope", [(12, 12, False), (12, 12, True),
                                         (12, 4, True), (8, 1, False)])
def test_k3_fused_decode_layer(dev, dtype, tol, nh, g, rope):
    gen = _gen(2)
    b, dh, bs, mb = 4, 64, 16, 12
    nb = b * mb + 3
    lens = torch.tensor([1, 17, 150, 192], device=dev, dtype=torch.int32)
    tables = torch.randperm(nb, device=dev, generator=gen)[:b * mb]
    tables = tables.view(b, mb).to(torch.int32)
    for i in range(b):
        tables[i, -(-int(lens[i]) // bs):] = nb + 5
    q = torch.randn(b, nh, dh, device=dev, generator=gen).to(dtype)
    kp = torch.randn(nb, bs, g, dh, device=dev, generator=gen).to(dtype)
    vp = torch.randn(nb, bs, g, dh, device=dev, generator=gen).to(dtype)
    w = torch.randn(nh * dh, 256, device=dev, generator=gen) * 0.03
    cos = sin = None
    if rope:
        ang = torch.rand(b, dh // 2, device=dev, generator=gen) * 6
        ang = torch.cat([ang, ang], -1)
        cos, sin = ang.cos(), ang.sin()
    out = tds.fused_decode_layer(q, kp, vp, tables, lens, w, rope_cos=cos,
                                 rope_sin=sin)
    ref = tds.fused_decode_layer(q, kp, vp, tables, lens, w, rope_cos=cos,
                                 rope_sin=sin, backend="reference")
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("top_k, top_p", [(None, None), (50, None),
                                          (None, 0.95), (50, 0.95)])
def test_k4_fused_sample_token_exact(dev, top_k, top_p):
    gen = _gen(3)
    x = torch.randn(8, 50304, device=dev, generator=gen) * 4
    temps = torch.tensor([0.8, 1.0, 0.0, 0.5, 1.5, 0.8, 0.0, 2.0],
                         device=dev)
    for words in [(1, 2), (0xDEADBEEF, 0x12345678)]:
        got = tfs.fused_sample(x, seed_words=words, temperature=temps,
                               top_k=top_k, top_p=top_p, vocab_limit=50257)
        want = tfs._sampling_plain(x, words, temps, top_k, top_p, 50257)
        assert torch.equal(got.cpu(), want.cpu())
        assert int(got.max()) < 50257


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
    (4, 4, True, True, 32)])
def test_k6_k7_flash_attention_bwd(dev, dtype, n, g, causal, padded, d):
    """K6 dq and K7 dk/dv against flash_attention_bwd_ref on the same o
    and lse; batch row 2 is fully masked when padded."""
    b, s = 3, 130
    q, k, v, do = _flash_inputs(dtype, b, s, n, g, d, seed=5)
    kpm = None
    if padded:
        lens = torch.tensor([130, 77, 0], device=dev)
        kpm = torch.arange(s, device=dev)[None] >= lens[:, None]
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                     key_padding_mask=kpm)
    before = (tfa.FLASH_BWD_DQ.launches, tfa.FLASH_BWD_DKV.launches)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  key_padding_mask=kpm)
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


def test_launch_counts_reset(dev):
    x = torch.randn(4, 64, device=dev)
    tln.fused_layer_norm(x)
    assert ku.launch_counts()["layer_norm_fwd"] >= 1
    ku.reset_launch_counts()
    assert set(ku.launch_counts().values()) == {0}
