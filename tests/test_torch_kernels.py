"""The port's hand-written CUDA kernels K1–K4 against their plain PyTorch
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


def test_launch_counts_reset(dev):
    x = torch.randn(4, 64, device=dev)
    tln.fused_layer_norm(x)
    assert ku.launch_counts()["layer_norm_fwd"] >= 1
    ku.reset_launch_counts()
    assert set(ku.launch_counts().values()) == {0}
