"""The port's prefill and decode_step (apex_tpu_torch.models.generate)
against the JAX package's, on the CPU at fp32, on both cache layouts with
ragged prompts: last-token logits, the written cache, and per-step
decode logits.  Logits tolerance 2e-4 as in tests/test_generate_paged.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.models import generate as tgen
from torch_port_cases import LENS, LOGIT_TOL, VARIANTS, _cfgs, _params, \
    _prompt, jgen


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_and_decode_steps_match(name, layout):
    jcfg, tcfg = _cfgs(name)
    jp, _, tp = _params(name)
    prompt = _prompt(jcfg.vocab_size, LENS)
    lens = np.asarray(LENS, np.int32)
    total = prompt.shape[1] + 4
    jcache = jgen.init_kv_cache(jcfg, len(LENS), total,
                                cache_layout=layout, block_size=4)
    tcache = tgen.init_kv_cache(tcfg, len(LENS), total, cache_layout=layout,
                                block_size=4, device="cpu")
    jl, jcache = jgen.prefill(jp, jnp.asarray(prompt), jcfg,
                              prompt_lens=jnp.asarray(lens), cache=jcache)
    tl, tcache = tgen.prefill(tp, torch.from_numpy(prompt), tcfg,
                              prompt_lens=torch.from_numpy(lens),
                              cache=tcache, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    for side in ("k", "v"):
        np.testing.assert_allclose(tcache[side].numpy(),
                                   np.asarray(jcache[side]), atol=LOGIT_TOL,
                                   rtol=0)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    rng = np.random.RandomState(1)
    j_step = jax.jit(functools.partial(jgen.decode_step, cfg=jcfg))
    for _ in range(3):
        tok = rng.randint(0, jcfg.vocab_size, (len(LENS),)).astype(np.int32)
        jl, jcache = j_step(jp, jnp.asarray(tok), jcache)
        tl, tcache = tgen.decode_step(tp, torch.from_numpy(tok), tcache,
                                      tcfg, device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
