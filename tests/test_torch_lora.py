"""The port's LoRA machinery (``apex_tpu_torch/models/lora.py``) against
the JAX package's on the CPU: the sort plan, the stacked slabs, the
batched delta, the merged weights and the LoRA-aware MLP, on adapters made
by the JAX package and carried across with ``lora_adapter_from_jax``.

Tolerances: the plan, the slabs and the slot-0 rows are exact; products
in fp32 agree within 1e-5 (other summation orders), the merged kernels
within 1e-6 (one rank-4 product added to O(0.02) weights).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import lora as jl
from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.quantized import quantize_params as j_quantize
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu_torch.models import lora as tl
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.models.quantized import quantize_params as t_quantize
from torch_port_cases import lora_pair

CFG = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
           vocab_size=64, max_position_embeddings=32)
JCFG = JConfig(compute_dtype=jnp.float32, remat=False, **CFG)
TCFG = TConfig(compute_dtype=torch.float32, **CFG)
RANK = 4


@functools.lru_cache(maxsize=None)
def _adapters(n, targets=jl.TARGETS, rank=RANK):
    return lora_pair(JCFG, n, rank=rank, targets=targets, alpha=2.0 * rank)


@pytest.mark.parametrize("idx", [
    [0, 3, 1, 3, 0, 2, 2, 1],            # mixed, ties keep their order
    [0, 0, 0, 0],                        # no adapter anywhere
    [4, 4, 4],                           # one slot, the last
    [2, 0, 1, 0, 1, 4, 0, 3, 3, 1, 2, 0]])
def test_lora_plan_matches_jax(idx):
    idx = np.asarray(idx, np.int32)
    jp = jl.lora_plan(jnp.asarray(idx), 4)
    tp = tl.lora_plan(torch.from_numpy(idx), 4)
    np.testing.assert_array_equal(tp["order"].numpy(), np.asarray(jp["order"]))
    np.testing.assert_array_equal(tp["offsets"].numpy(),
                                  np.asarray(jp["offsets"]))
    assert tp["offsets"].dtype == torch.int32


def test_stack_adapter_slabs_matches_jax():
    ja, ta = _adapters(4)
    js = jl.stack_adapter_slabs([ja[0], None, ja[2], ja[1]], JCFG)
    ts = tl.stack_adapter_slabs([ta[0], None, ta[2], ta[1]], TCFG)
    assert set(ts) == set(js) == set(jl.TARGETS)
    for t in js:
        for f in ("a", "b"):
            np.testing.assert_allclose(ts[t][f].numpy(), np.asarray(js[t][f]),
                                       rtol=1e-7, atol=0)
        assert int(torch.count_nonzero(ts[t]["a"][:, 1])) == 0
    assert tl.adapter_bytes(ta[0]) == jl.adapter_bytes(ja[0])
    with pytest.raises(ValueError):
        tl.stack_adapter_slabs([None, None], TCFG)
    _, odd = _adapters(1, rank=2)
    with pytest.raises(ValueError):
        tl.stack_adapter_slabs([ta[0], odd[0]], TCFG)


@functools.lru_cache(maxsize=None)
def _slabs(n):
    ja, ta = _adapters(n)
    return jl.stack_adapter_slabs(ja, JCFG), tl.stack_adapter_slabs(ta, TCFG)


@pytest.mark.parametrize("target", jl.TARGETS)
@pytest.mark.parametrize("idx", [[0, 3, 1, 3, 0, 2, 2, 1], [0, 0, 0],
                                 [1, 2, 3, 4, 4, 3, 2, 1, 0, 2]])
def test_batched_lora_delta_matches_jax(target, idx):
    js, ts = (s[target] for s in _slabs(4))
    d_in = jl.target_shapes(JCFG)[target][0]
    idx = np.asarray(idx, np.int32)
    x = np.random.RandomState(len(idx)).randn(len(idx), 1, d_in).astype(
        np.float32)
    want = jl.batched_lora_delta(jnp.asarray(x), js["a"][0], js["b"][0],
                                 jl.lora_plan(jnp.asarray(idx), 4))
    got = tl.batched_lora_delta(torch.from_numpy(x), ts["a"][0], ts["b"][0],
                                tl.lora_plan(torch.from_numpy(idx), 4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # slot-0 rows carry no delta at all
    assert (got.numpy()[idx == 0] == 0).all()


def test_batched_delta_equals_per_row_merge_math():
    """Each row's delta is scaling * x @ A @ B of its own adapter."""
    _, ta = _adapters(3)
    ts = _slabs(3)[1]["fc1"]
    idx = torch.tensor([2, 0, 3, 1, 1], dtype=torch.int32)
    x = torch.randn(5, 1, 32, generator=torch.Generator().manual_seed(0))
    got = tl.batched_lora_delta(x, ts["a"][1], ts["b"][1],
                                tl.lora_plan(idx, 3))
    for r, s in enumerate(idx.tolist()):
        if s == 0:
            assert not got[r].any()
            continue
        ad = ta[s - 1]
        want = x[r] @ ad.a["fc1"][1] @ ad.b["fc1"][1] * ad.scaling
        torch.testing.assert_close(got[r], want, rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _params():
    jp = j_init(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("targets", [jl.TARGETS, ("qkv", "fc2")])
def test_merge_lora_matches_jax(targets):
    jp, tp = _params()
    ja, ta = _adapters(1, targets=targets)
    jm = jl.merge_lora(jp, JCFG, ja[0])
    tm = tl.merge_lora(tp, TCFG, ta[0])
    for name in ("qkv_kernel", "proj_kernel", "fc1_kernel", "fc2_kernel"):
        np.testing.assert_allclose(tm["layers"][name].numpy(),
                                   np.asarray(jm["layers"][name]),
                                   rtol=1e-6, atol=1e-6)
    # the base tree is untouched
    np.testing.assert_array_equal(tp["layers"]["qkv_kernel"].numpy(),
                                  np.asarray(jp["layers"]["qkv_kernel"]))


def test_merge_lora_refuses_a_quantized_base():
    jp, tp = _params()
    _, ta = _adapters(4)
    with pytest.raises(ValueError, match="quantized"):
        tl.merge_lora(t_quantize(tp), TCFG, ta[0])
    with pytest.raises(ValueError, match="quantized"):
        jl.merge_lora(j_quantize(jp), JCFG, _adapters(4)[0][0])


@pytest.mark.parametrize("quant", [False, True])
def test_lora_mlp_matches_jax(quant):
    jp, tp = _params()
    if quant:
        jp, tp = j_quantize(jp), t_quantize(tp)
    js, ts = _slabs(3)
    layer = 1
    jlp = jax.tree.map(lambda a: a[layer], jp["layers"])
    tlp = {k: ({kk: vv[layer] for kk, vv in v.items()}
               if isinstance(v, dict) else v[layer])
           for k, v in tp["layers"].items()}
    jll = jax.tree.map(lambda a: a[layer], js)
    tll = {t: {f: v[layer] for f, v in ab.items()} for t, ab in ts.items()}
    idx = np.asarray([0, 2, 1, 3, 0, 2], np.int32)
    x = np.random.RandomState(5).randn(6, 1, 32).astype(np.float32)
    want = jl.lora_mlp(JCFG, jlp, jnp.asarray(x), jll,
                       jl.lora_plan(jnp.asarray(idx), 3))
    got = tl.lora_mlp(TCFG, tlp, torch.from_numpy(x), tll,
                      tl.lora_plan(torch.from_numpy(idx), 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_init_lora_adapter_contract():
    cfg = TCFG
    a1 = tl.init_lora_adapter(torch.Generator().manual_seed(3), cfg,
                              rank=RANK, b_std=0.02)
    a2 = tl.init_lora_adapter(torch.Generator().manual_seed(3), cfg,
                              rank=RANK, b_std=0.02)
    zero_b = tl.init_lora_adapter(torch.Generator().manual_seed(3), cfg,
                                  rank=RANK)
    ja = _adapters(1)[0][0]
    assert a1.targets == jl.TARGETS and a1.scaling == 1.0
    for t in jl.TARGETS:
        assert a1.a[t].shape == tuple(ja.a[t].shape)
        assert a1.b[t].shape == tuple(ja.b[t].shape)
        assert torch.equal(a1.a[t], a2.a[t]) and torch.equal(a1.b[t],
                                                             a2.b[t])
        assert not zero_b.b[t].any()
    assert tl.adapter_bytes(a1) == jl.adapter_bytes(ja)
    # A ~ N(0, 1/r): the fc1 factor's 2*32*4 draws
    std = float(a1.a["fc1"].std())
    assert 0.35 < std < 0.65
    with pytest.raises(ValueError):
        tl.init_lora_adapter(torch.Generator(), cfg, rank=0)
    with pytest.raises(ValueError):
        tl.init_lora_adapter(torch.Generator(), cfg, targets=("mlp",))


def test_lora_mlp_swiglu_waits_for_its_port():
    """The swiglu branch is ported (it raised before): with
    no adapter rows it is the swiglu MLP; the JAX comparison is
    tests/test_torch_swiglu.py."""
    from apex_tpu_torch.models.transformer_lm import _mlp

    cfg = TConfig(compute_dtype=torch.float32, activation="swiglu", **CFG)
    gen = torch.Generator().manual_seed(0)
    f = cfg.ffn_hidden_size
    lp = {"fc1_kernel": torch.randn(32, 2, f, generator=gen) * 0.1,
          "fc1_bias": torch.randn(2, f, generator=gen) * 0.1,
          "fc2_kernel": torch.randn(f, 32, generator=gen) * 0.1,
          "fc2_bias": torch.zeros(32)}
    x = torch.randn(3, 1, 32, generator=gen)
    got = tl.lora_mlp(cfg, lp, x, {}, tl.lora_plan(
        torch.zeros(3, dtype=torch.int32), 1))
    torch.testing.assert_close(got, _mlp(cfg, lp, x))
