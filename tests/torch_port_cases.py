"""Shared cases of the port-vs-JAX serving tests
(tests/test_torch_generate.py, tests/test_torch_prefill_decode.py): the
two small GPT configurations, their JAX and converted parameters, and
ragged prompts made with numpy from a seed."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.convert import params_from_numpy

# the package re-exports the function `generate` over its module name
jgen = importlib.import_module("apex_tpu.models.generate")

LOGIT_TOL = 2e-4

BASE = dict(num_layers=2, hidden_size=128, num_attention_heads=4,
            vocab_size=256, max_position_embeddings=64)
VARIANTS = {
    "learned_mha_gelu": {},
    "rope_gqa_swiglu": dict(position_embedding_type="rope",
                            num_query_groups=2, activation="swiglu",
                            normalization="rmsnorm"),
}
LENS = [5, 11, 8]


def _cfgs(name):
    kw = dict(BASE, **VARIANTS[name])
    return (JConfig(compute_dtype=jnp.float32, **kw),
            TConfig(compute_dtype=torch.float32, **kw))


_PARAMS = {}


def _params(name):
    if name not in _PARAMS:
        jcfg, _ = _cfgs(name)
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree.map(np.asarray, jp)
        _PARAMS[name] = (jp, tree, params_from_numpy(tree, device="cpu"))
    return _PARAMS[name]


def _prompt(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    batch = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        batch[i, :n] = rng.randint(0, vocab, (n,))
    return batch


def lora_pair(jcfg, n, *, rank=4, targets=None, alpha=None, seed=100):
    """n LoRA adapters with seeded numpy factors (``A ~ N(0, 1/r)``, ``B ~
    N(0, 0.05²)``) as JAX ``LoRAAdapter``s, and the same adapters carried
    into the port with ``lora_adapter_from_jax``."""
    from apex_tpu.models import lora as jl
    from apex_tpu_torch.models.convert import lora_adapter_from_jax

    targets = jl.TARGETS if targets is None else tuple(targets)
    shapes = jl.target_shapes(jcfg)
    L = jcfg.num_layers
    ja = []
    for i in range(n):
        rng = np.random.RandomState(seed + i)
        a = {t: jnp.asarray(rng.randn(L, shapes[t][0], rank) / rank ** 0.5,
                            jnp.float32) for t in targets}
        b = {t: jnp.asarray(rng.randn(L, rank, shapes[t][1]) * 0.05,
                            jnp.float32) for t in targets}
        ja.append(jl.LoRAAdapter(rank=rank, alpha=float(alpha or rank),
                                 a=a, b=b))
    return ja, [lora_adapter_from_jax(a, device="cpu") for a in ja]
