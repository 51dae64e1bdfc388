"""The port's ``decode_verify`` against the JAX package's on the CPU at
fp32: m tokens appended after a ragged prefill, on the contiguous stripe,
the paged pool and the int8 paged pool, with and without per-row LoRA
deltas (the GQA/rope/swiglu variant takes deltas on qkv and proj only:
``lora_mlp``'s swiglu branch waits for ``ops/swiglu``).  Logits within
2e-4 (tests/test_speculative.py's tolerance), caches within the same;
an int8 pool's written K/V compared after dequantization, within one
quantization step.  A gold block through verify equals m ``decode_step``
calls of the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import lora as jl
from apex_tpu_torch.models import generate as tgen
from apex_tpu_torch.models import lora as tl
from apex_tpu_torch.serving.paged_cache import dequantize_kv
from torch_port_cases import (
    LENS, LOGIT_TOL, _cfgs, _params, _prompt, jgen, lora_pair)

M = 4
LAYOUTS = [("contiguous", None), ("paged", None), ("paged", "int8")]
IDX = [2, 0, 1]                  # one lane per slot kind, 3 slots


def _lora(name, jcfg):
    targets = None if name == "learned_mha_gelu" else ("qkv", "proj")
    ja, ta = lora_pair(jcfg, 3, targets=targets)
    idx = np.asarray(IDX, np.int32)
    return ({"idx": jnp.asarray(idx),
             "slabs": jl.stack_adapter_slabs(ja, jcfg)},
            {"idx": torch.from_numpy(idx),
             "slabs": tl.stack_adapter_slabs(ta, _cfgs(name)[1])})


def _caches(name, layout, wire, extra):
    jcfg, tcfg = _cfgs(name)
    jp, _, tp = _params(name)
    prompt = _prompt(jcfg.vocab_size, LENS)
    lens = np.asarray(LENS, np.int32)
    total = prompt.shape[1] + M + extra
    jc = jgen.init_kv_cache(jcfg, len(LENS), total, cache_layout=layout,
                            block_size=4, cache_wire=wire)
    tc = tgen.init_kv_cache(tcfg, len(LENS), total, cache_layout=layout,
                            block_size=4, cache_wire=wire, device="cpu")
    _, jc = jgen.prefill(jp, jnp.asarray(prompt), jcfg,
                         prompt_lens=jnp.asarray(lens), cache=jc)
    _, tc = tgen.prefill(tp, torch.from_numpy(prompt), tcfg,
                         prompt_lens=torch.from_numpy(lens), cache=tc,
                         device="cpu")
    return jcfg, tcfg, jp, tp, jc, tc


def _kv(cache, side):
    if "k_scale" in cache:
        return dequantize_kv(cache[side], cache[f"{side}_scale"]).numpy()
    return cache[side].numpy()


def _jkv(cache, side):
    w = np.asarray(cache[side], np.float32)
    if "k_scale" in cache:
        return w * np.asarray(cache[f"{side}_scale"])[..., None]
    return w


@pytest.mark.parametrize("name, lora", [
    ("learned_mha_gelu", False), ("learned_mha_gelu", True),
    ("rope_gqa_swiglu", True)])
@pytest.mark.parametrize("layout, wire", LAYOUTS)
def test_decode_verify_matches_jax(name, layout, wire, lora):
    jcfg, tcfg, jp, tp, jc, tc = _caches(name, layout, wire, 0)
    toks = np.random.RandomState(7).randint(
        0, jcfg.vocab_size, (len(LENS), M)).astype(np.int32)
    jlora, tlora = _lora(name, jcfg) if lora else (None, None)
    verify = jax.jit(functools.partial(jgen.decode_verify, cfg=jcfg))
    jlog, jc = verify(jp, jnp.asarray(toks), jc, lora=jlora)
    tlog, tc = tgen.decode_verify(tp, torch.from_numpy(toks), tc, tcfg,
                                  lora=tlora, device="cpu")
    assert tlog.shape == (len(LENS), M, jcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    # one int8 step of the largest |K| when the pool is quantized
    tol = LOGIT_TOL if wire is None else 2 * float(
        np.abs(np.asarray(jc["k_scale"])).max())
    for side in ("k", "v"):
        np.testing.assert_allclose(_kv(tc, side), _jkv(jc, side), atol=tol,
                                   rtol=0)


@pytest.mark.parametrize("layout, wire", LAYOUTS)
def test_lora_decode_step_matches_jax(layout, wire):
    name = "learned_mha_gelu"
    jcfg, tcfg, jp, tp, jc, tc = _caches(name, layout, wire, 0)
    jlora, tlora = _lora(name, jcfg)
    step = jax.jit(functools.partial(jgen.decode_step, cfg=jcfg))
    rng = np.random.RandomState(3)
    for _ in range(3):
        tok = rng.randint(0, jcfg.vocab_size, (len(LENS),)).astype(np.int32)
        jlog, jc = step(jp, jnp.asarray(tok), jc, lora=jlora)
        tlog, tc = tgen.decode_step(tp, torch.from_numpy(tok), tc, tcfg,
                                    lora=tlora, device="cpu")
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("layout, wire", LAYOUTS)
def test_gold_block_equals_stepwise_decode(layout, wire, lora):
    """The same M tokens through one verify and through M decode steps of
    the port: the same logits and the same cache."""
    name = "learned_mha_gelu"
    jcfg, tcfg, _, tp, _, tc = _caches(name, layout, wire, 0)
    _, _, _, _, _, sc = _caches(name, layout, wire, 0)
    toks = torch.from_numpy(np.random.RandomState(9).randint(
        0, jcfg.vocab_size, (len(LENS), M)).astype(np.int32))
    tlora = _lora(name, jcfg)[1] if lora else None
    vlog, tc = tgen.decode_verify(tp, toks, tc, tcfg, lora=tlora,
                                  device="cpu")
    slog = []
    for j in range(M):
        lg, sc = tgen.decode_step(tp, toks[:, j], sc, tcfg, lora=tlora,
                                  device="cpu")
        slog.append(lg)
    np.testing.assert_allclose(vlog.numpy(), torch.stack(slog, 1).numpy(),
                               atol=LOGIT_TOL, rtol=0)
    for side in ("k", "v"):
        np.testing.assert_allclose(_kv(tc, side), _kv(sc, side),
                                   atol=LOGIT_TOL, rtol=0)


def test_verify_writes_past_the_stripe_drop():
    """A block that runs past the cache end writes what fits, like JAX's
    mode="drop"; its logits still match."""
    name = "learned_mha_gelu"
    jcfg, tcfg, jp, tp, jc, tc = _caches(name, "contiguous", None, -3)
    toks = np.random.RandomState(2).randint(
        0, jcfg.vocab_size, (len(LENS), M)).astype(np.int32)
    jlog, jc = jgen.decode_verify(jp, jnp.asarray(toks), jc, jcfg)
    tlog, tc = tgen.decode_verify(tp, torch.from_numpy(toks), tc, tcfg,
                                  device="cpu")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=LOGIT_TOL, rtol=0)
