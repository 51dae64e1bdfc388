"""The port's serving path (apex_tpu_torch.models.generate) against the
JAX package's, on the CPU at fp32: the parameter converter, and greedy
generate tokens on both cache layouts with ragged prompts (prefill and
decode_step alone: tests/test_torch_prefill_decode.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.models import generate as tgen
from apex_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from torch_port_cases import LENS, VARIANTS, _cfgs, _params, _prompt, jgen


@pytest.mark.parametrize("name", list(VARIANTS))
def test_converter_round_trip_leaf_for_leaf(name):
    _, tree, tp = _params(name)
    back = params_to_numpy(tp)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_converter_bf16_goes_through_float32():
    tree = {"w": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))}
    t = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert t["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params_to_numpy(t)["w"], [1.5, -2.25])


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_greedy_generate_token_identical(name, layout):
    jcfg, tcfg = _cfgs(name)
    jp, _, tp = _params(name)
    prompt = _prompt(jcfg.vocab_size, LENS, seed=2)
    lens = np.asarray(LENS, np.int32)
    want = jgen.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=6,
                         prompt_lens=jnp.asarray(lens), cache_layout=layout,
                         block_size=4)
    got = tgen.generate(tp, torch.from_numpy(prompt), tcfg, max_new_tokens=6,
                        prompt_lens=torch.from_numpy(lens),
                        cache_layout=layout, block_size=4, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name, wire, quant", [
    ("learned_mha_gelu", "int8", False), ("rope_gqa_swiglu", None, True),
    ("rope_gqa_swiglu", "int8", True)])
def test_int8_pool_and_quantized_weights_generate_token_identical(
        name, wire, quant):
    """Paged generate with a block-scaled int8 pool and/or
    ``quantize_params`` weights: greedy tokens equal the JAX package's."""
    from apex_tpu.models.quantized import quantize_params as j_quantize
    from apex_tpu_torch.models.quantized import quantize_params as t_quantize

    jcfg, tcfg = _cfgs(name)
    jp, _, tp = _params(name)
    if quant:
        jp, tp = j_quantize(jp), t_quantize(tp)
    prompt = _prompt(jcfg.vocab_size, LENS, seed=5)
    lens = np.asarray(LENS, np.int32)
    want = jgen.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=6,
                         prompt_lens=jnp.asarray(lens), cache_layout="paged",
                         block_size=4, cache_wire=wire)
    got = tgen.generate(tp, torch.from_numpy(prompt), tcfg, max_new_tokens=6,
                        prompt_lens=torch.from_numpy(lens),
                        cache_layout="paged", block_size=4, cache_wire=wire,
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_eos_freezes_rows():
    """A row that emits EOS writes it, then stops writing; the loop ends
    once every row is done (the JAX while-loop's contract)."""
    jcfg, tcfg = _cfgs("learned_mha_gelu")
    jp, _, tp = _params("learned_mha_gelu")
    prompt = _prompt(jcfg.vocab_size, LENS, seed=3)
    lens = np.asarray(LENS, np.int32)
    free = tgen.generate(tp, torch.from_numpy(prompt), tcfg,
                         max_new_tokens=6, prompt_lens=torch.from_numpy(lens),
                         device="cpu")
    eos = int(free[0, LENS[0] + 1])
    want = jgen.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=6,
                         prompt_lens=jnp.asarray(lens), eos_token_id=eos)
    got = tgen.generate(tp, torch.from_numpy(prompt), tcfg, max_new_tokens=6,
                        prompt_lens=torch.from_numpy(lens), eos_token_id=eos,
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, LENS[0] + 2]) == 0


def test_sampled_generate_is_seeded_and_in_vocab():
    _, tcfg = _cfgs("learned_mha_gelu")
    _, _, tp = _params("learned_mha_gelu")
    prompt = torch.from_numpy(_prompt(tcfg.vocab_size, LENS, seed=4))
    kw = dict(max_new_tokens=5, temperature=0.8, top_k=20, top_p=0.9,
              vocab_limit=200, prompt_lens=torch.tensor(LENS),
              cache_layout="paged", device="cpu")
    a = tgen.generate(tp, prompt, tcfg, seed=7, **kw)
    b = tgen.generate(tp, prompt, tcfg, seed=7, **kw)
    assert torch.equal(a, b)
    for i, n in enumerate(LENS):
        assert int(a[i, n:n + 5].max()) < 200


@pytest.mark.parametrize("kw, match", [
    (dict(spec="ngram"), "speculative"),
])
def test_unported_options_raise(kw, match):
    """``spec=`` is ported now (tests/test_torch_speculative.py); what it
    still refuses is the JAX package's refusal: learned positions without
    room for the k+1 cells a verify block writes past the budget."""
    _, tcfg = _cfgs("learned_mha_gelu")
    _, _, tp = _params("learned_mha_gelu")
    out = tgen.generate(tp, torch.zeros(1, 3, dtype=torch.long), tcfg,
                        max_new_tokens=2, device="cpu", **kw)
    assert out.shape == (1, 5)
    with pytest.raises(ValueError, match=match):
        tgen.generate(tp, torch.zeros(1, 3, dtype=torch.long), tcfg,
                      max_new_tokens=tcfg.max_position_embeddings - 3,
                      device="cpu", **kw)


@pytest.mark.parametrize("layout, wire", [("paged", None), ("paged", "int8"),
                                          ("contiguous", None)])
def test_mqa_greedy_generate_token_identical(layout, wire):
    """MQA (``num_query_groups=1``) with 12 query heads on the one kv group,
    as ``gpt_125m(num_query_groups=1)`` has: the rep the paged decode
    kernels refused before their split-key redesign.  Greedy tokens equal
    the JAX package's on both cache layouts and an int8 pool."""
    from apex_tpu.models.config import TransformerConfig as JConfig
    from apex_tpu.models.transformer_lm import init_gpt_params as j_init
    from apex_tpu_torch.models.config import TransformerConfig as TConfig
    from apex_tpu_torch.models.convert import params_from_numpy

    kw = dict(num_layers=2, hidden_size=192, num_attention_heads=12,
              num_query_groups=1, vocab_size=256, max_position_embeddings=64)
    jcfg = JConfig(compute_dtype=jnp.float32, **kw)
    tcfg = TConfig(compute_dtype=torch.float32, **kw)
    jp = j_init(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    lens = [5, 19, 12, 1]
    prompt = _prompt(jcfg.vocab_size, lens, seed=7)
    jl = np.asarray(lens, np.int32)
    want = jgen.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=8,
                         prompt_lens=jnp.asarray(jl), cache_layout=layout,
                         block_size=4, cache_wire=wire)
    got = tgen.generate(tp, torch.from_numpy(prompt), tcfg, max_new_tokens=8,
                        prompt_lens=torch.from_numpy(jl), cache_layout=layout,
                        block_size=4, cache_wire=wire, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
