"""Fused bias + SwiGLU of the port (``apex_tpu_torch/ops/swiglu.py``) and
its three call sites (the GPT MLP, ``lora_mlp``, the MoE experts) against
the JAX package on the CPU.

- The op: the forward and the gradients of x and the bias against
  ``jax.vjp`` of ``fused_bias_swiglu`` / ``_paired``, fp32 within 1e-6
  (one summation order of dbias apart), bf16 within one bf16 ulp of the
  output scale (2**-7 relative).
- A swiglu GPT (rope, grouped queries: the Llama block) steps 6 times at
  O2 in lockstep with JAX from one converted state: losses within 3e-2,
  identical scaler decisions (tests/torch_train_cases.py's O2 bounds).
- swiglu ``lora_mlp`` against JAX's within 1e-5 (fp32), and each
  tenant's rows against the merged-weights MLP within 1e-5.
- swiglu experts under capacity and ragged routing: the MoE step at O0
  (fp32) in lockstep with JAX for 4 steps, losses within 1e-4
  (tests/torch_train_cases.py's O0 bound).  The JAX ragged backward
  returns a ``[2f]`` cotangent for the per-row ``[N, 2f]`` bias of its
  ``fused_bias_swiglu`` and raises, so the test points that call at
  ``bias_swiglu_ref`` (plain autodiff of the same forward) for its
  duration; nothing under apex_tpu/ is edited.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.scaler import LossScaleState as JLossScaleState
from apex_tpu.models import lora as jl
from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.config import gpt_tiny as j_tiny
from apex_tpu.models.gpt import make_gpt_train_step as j_make
from apex_tpu.models.transformer_lm import _mlp as j_mlp
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu.models.transformer_lm import single_device_ctx
from apex_tpu.ops import swiglu as jsw
from apex_tpu.optimizers import fused_adam as j_adam
from apex_tpu_torch.models import lora as tl
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.config import gpt_tiny as t_tiny
from apex_tpu_torch.models.convert import (
    params_from_numpy, train_state_from_jax)
from apex_tpu_torch.models.gpt import make_gpt_train_step as t_make
from apex_tpu_torch.models.transformer_lm import _mlp as t_mlp
from apex_tpu_torch.ops import swiglu as tsw
from apex_tpu_torch.optimizers import fused_adam as t_adam
from torch_port_cases import lora_pair
from torch_train_cases import one_torch_thread, oracle_jit  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OP_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
LOSS_TOL = {"O0": 1e-4, "O2": 3e-2}


def _jt(a, dtype):
    if a is None:
        return None, None
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().detach().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=OP_TOL[dtype] * scale,
                               rtol=OP_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_fused_bias_swiglu_matches_jax(dtype, bias):
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, 16) * 2).astype(np.float32)
    b = rng.randn(16).astype(np.float32) if bias else None
    g = rng.randn(3, 5, 8).astype(np.float32)
    jx, tx = _jt(x, dtype)
    jb, tb = _jt(b, dtype)
    jg, tg = _jt(g, dtype)
    jy, vjp = jax.vjp(lambda a, c: jsw.fused_bias_swiglu(a, c), jx, jb)
    jdx, jdb = vjp(jg)
    tx.requires_grad_(True)
    if tb is not None:
        tb.requires_grad_(True)
    ty = tsw.fused_bias_swiglu(tx, tb)
    assert ty.dtype == tx.dtype
    ty.backward(tg)
    _close(ty, jy, dtype)
    _close(tx.grad, jdx, dtype)
    if bias:
        _close(tb.grad, jdb, dtype)
    _close(tsw.bias_swiglu_ref(tx.detach(), None if tb is None
                               else tb.detach()), jsw.bias_swiglu_ref(jx, jb),
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_fused_bias_swiglu_paired_matches_jax(dtype, bias):
    rng = np.random.RandomState(2)
    y = (rng.randn(2, 7, 2, 12) * 2).astype(np.float32)
    b = rng.randn(2, 12).astype(np.float32) if bias else None
    g = rng.randn(2, 7, 12).astype(np.float32)
    jy, ty = _jt(y, dtype)
    jb, tb = _jt(b, dtype)
    jg, tg = _jt(g, dtype)
    jo, vjp = jax.vjp(lambda a, c: jsw.fused_bias_swiglu_paired(a, c), jy, jb)
    jdy, jdb = vjp(jg)
    ty.requires_grad_(True)
    if tb is not None:
        tb.requires_grad_(True)
    to = tsw.fused_bias_swiglu_paired(ty, tb)
    to.backward(tg)
    _close(to, jo, dtype)
    _close(ty.grad, jdy, dtype)
    if bias:
        _close(tb.grad, jdb, dtype)


def test_per_row_bias_gradient_is_the_plain_autodiff():
    """A bias as wide as x (the ragged experts' gathered rows) gets its
    own rows' gradient: plain autodiff of the reference forward."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(6, 10).astype(np.float32))
    b = torch.from_numpy(rng.randn(6, 10).astype(np.float32))
    g = torch.from_numpy(rng.randn(6, 5).astype(np.float32))
    x1, b1 = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
    tsw.fused_bias_swiglu(x1, b1).backward(g)
    x2, b2 = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
    tsw.bias_swiglu_ref(x2, b2).backward(g)
    torch.testing.assert_close(b1.grad, b2.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-6, atol=1e-6)


def test_shape_checks():
    with pytest.raises(ValueError, match="even"):
        tsw.fused_bias_swiglu(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="paired"):
        tsw.fused_bias_swiglu_paired(torch.zeros(2, 3, 4))


LLAMA = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             num_query_groups=2, vocab_size=256, max_position_embeddings=32,
             activation="swiglu", position_embedding_type="rope",
             normalization="rmsnorm", ffn_hidden_size=96)


def test_mlp_site_matches_jax():
    jcfg = j_tiny(compute_dtype=jnp.float32, scan_layers=False, **LLAMA)
    tcfg = t_tiny(compute_dtype=torch.float32, **LLAMA)
    jp = j_init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    tlp = {k: v[1] for k, v in tp["layers"].items()}
    x = np.random.RandomState(4).randn(2, 5, 64).astype(np.float32)
    want = j_mlp(jcfg, jlp, jnp.asarray(x), single_device_ctx())
    got = t_mlp(tcfg, tlp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _lockstep(jcfg, tcfg, level, steps, batch, seq, seed=0):
    j_init_fn, j_step = j_make(jcfg, j_adam(lr=1e-3), level)
    j_step = oracle_jit(j_step)
    jstate = j_init_fn(jax.random.PRNGKey(seed))
    if level == "O2":
        jstate = jstate._replace(loss_scale_state=JLossScaleState(
            jnp.float32(2.0 ** 15), jnp.int32(0)))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    _, t_step = t_make(tcfg, t_adam(lr=1e-3), level, device="cpu")
    rng = np.random.RandomState(seed + 7)
    out = {"j": [], "t": []}
    for _ in range(steps):
        tok = rng.randint(0, tcfg.vocab_size, (batch, seq)).astype(np.int32)
        lab = rng.randint(0, tcfg.vocab_size, (batch, seq)).astype(np.int32)
        jstate, jm = j_step(jstate, jnp.asarray(tok), jnp.asarray(lab))
        tstate, tm = t_step(tstate, torch.from_numpy(tok),
                            torch.from_numpy(lab))
        for k, m in (("j", jm), ("t", tm)):
            out[k].append((float(m["loss"]), bool(m["overflow"]),
                           float(m["loss_scale"])))
    jl_ = np.array([s[0] for s in out["j"]])
    tl_ = np.array([s[0] for s in out["t"]])
    assert np.isfinite(tl_).all()
    np.testing.assert_allclose(tl_, jl_, atol=LOSS_TOL[level], rtol=0)
    assert [s[1:] for s in out["t"]] == [s[1:] for s in out["j"]]


@pytest.mark.parametrize("fused_head", [False, True])
def test_swiglu_gpt_step_tracks_jax(fused_head):
    kw = dict(LLAMA, fused_head_ce=fused_head, head_ce_chunk=24)
    _lockstep(j_tiny(compute_dtype=jnp.bfloat16, scan_layers=False, **kw),
              t_tiny(compute_dtype=torch.bfloat16, **kw), "O2", 6, 2, 32)


MOE = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=16, num_experts=4,
           activation="swiglu", ffn_hidden_size=96)


@pytest.fixture
def jax_ragged_swiglu_autodiff(monkeypatch):
    monkeypatch.setattr(jsw, "fused_bias_swiglu", jsw.bias_swiglu_ref)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("routing", ["capacity", "ragged"])
def test_swiglu_experts_step_tracks_jax(jax_ragged_swiglu_autodiff,
                                        routing, top_k):
    kw = dict(MOE, moe_routing=routing, moe_top_k=top_k)
    _lockstep(j_tiny(compute_dtype=jnp.float32, scan_layers=False, **kw),
              t_tiny(compute_dtype=torch.float32, **kw), "O0", 4, 2, 16,
              seed=3)


CFG = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
           vocab_size=64, max_position_embeddings=32, activation="swiglu",
           ffn_hidden_size=48)
JCFG = JConfig(compute_dtype=jnp.float32, remat=False, **CFG)
TCFG = TConfig(compute_dtype=torch.float32, **CFG)


@functools.lru_cache(maxsize=None)
def _lora_case():
    jp = j_init(jax.random.PRNGKey(0), JCFG)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ja, ta = lora_pair(JCFG, 3, rank=4, alpha=8.0)
    return jp, tp, ja, ta


def test_swiglu_lora_mlp_matches_jax_and_each_merged_tenant():
    jp, tp, ja, ta = _lora_case()
    assert tuple(ja[0].b["fc1"].shape) == (2, 4, 96)   # [L, r, 2f]
    js = jl.stack_adapter_slabs(ja, JCFG)
    ts = tl.stack_adapter_slabs(ta, TCFG)
    layer = 1
    jlp = jax.tree.map(lambda a: a[layer], jp["layers"])
    tlp = {k: v[layer] for k, v in tp["layers"].items()}
    jll = jax.tree.map(lambda a: a[layer], js)
    tll = {t: {f: v[layer] for f, v in ab.items()} for t, ab in ts.items()}
    idx = np.asarray([0, 2, 1, 3, 0, 2, 3], np.int32)
    x = np.random.RandomState(5).randn(7, 1, 32).astype(np.float32)
    want = jl.lora_mlp(JCFG, jlp, jnp.asarray(x), jll,
                       jl.lora_plan(jnp.asarray(idx), 3))
    got = tl.lora_mlp(TCFG, tlp, torch.from_numpy(x), tll,
                      tl.lora_plan(torch.from_numpy(idx), 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for r, s in enumerate(idx.tolist()):
        base = tp if s == 0 else tl.merge_lora(tp, TCFG, ta[s - 1])
        mlp = {k: v[layer] for k, v in base["layers"].items()}
        row = t_mlp(TCFG, mlp, torch.from_numpy(x[r:r + 1]))
        np.testing.assert_allclose(got[r:r + 1].numpy(), row.numpy(),
                                   rtol=1e-5, atol=1e-5)
