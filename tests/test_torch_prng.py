"""apex_tpu_torch.utils.prng against jax.random (threefry2x32, the
partitionable split of JAX's defaults), and dropout under accum_steps
over it.

Keys: ``key``, ``split`` and ``layer_words`` equal ``jax.random``'s key
data bit for bit over many seeds and counts, and on keys of any integer
dtype.  Then the GPT O2 step with dropout at accum_steps 2 and 4 runs in
lockstep with the JAX step given the same raw key each step: the JAX
``_dropout`` and ``_drop_path`` point at the flash kernels' counter hash
(tests/test_torch_train_dropout.py's ``hashed_jax``), so the masks are
equal exactly when the derived keys are.  Tolerances are those of
tests/torch_train_cases.py: losses within 3e-2, gradient norms within
2e-2 relative, identical scaler decisions; and a step fed the key words
JAX derives by hand equals the step fed the raw key bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.frontend import make_train_step as j_make
from apex_tpu.amp.scaler import LossScaleState as JLossScaleState
from apex_tpu.models.config import gpt_tiny as j_tiny
from apex_tpu.models.transformer_lm import gpt_loss as j_gpt_loss
from apex_tpu.models.transformer_lm import init_gpt_params as j_init_params
from apex_tpu.optimizers import fused_adam as j_adam
from apex_tpu.optimizers._common import global_norm as j_global_norm
from apex_tpu_torch.amp import make_train_step as t_make
from apex_tpu_torch.amp.scaler import LossScaleState
from apex_tpu_torch.models.config import gpt_tiny as t_tiny
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.models.transformer_lm import gpt_loss as t_gpt_loss
from apex_tpu_torch.optimizers import fused_adam as t_adam
from apex_tpu_torch.optimizers import global_norm as t_global_norm
from apex_tpu_torch.utils import prng
from test_torch_train_dropout import (  # noqa: F401  (the fixture)
    GPT_GEOM, hashed_jax, layer_words)

SEEDS = [0, 1, 7, 42, 1234, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 5,
         -1, -7, 987654321]
COUNTS = [1, 2, 3, 4, 5, 8, 17, 64]
LOSS_TOL, NORM_RTOL = 3e-2, 2e-2


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _raw_key(k):
    """A JAX key as the generic step takes it: [2] torch.uint32 words."""
    return torch.from_numpy(np.array(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_equals_prngkey(seed):
    assert np.array_equal(prng.key(seed).numpy(), _data(_jkey(seed)))


@pytest.mark.parametrize("num", COUNTS)
@pytest.mark.parametrize("seed", SEEDS)
def test_split_equals_jax_bit_for_bit(seed, num):
    k = _jkey(seed)
    want = _data(jax.random.split(k, num))
    assert np.array_equal(prng.split(np.asarray(k), num).numpy(), want)
    # a key derived twice (the per-layer split of a per-microbatch key)
    k2 = jax.random.split(k, 3)[2]
    want2 = _data(jax.random.split(k2, num))
    got2 = prng.split(prng.split(prng.key(seed), 3)[2], num)
    assert np.array_equal(got2.numpy(), want2)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_key_data_of_any_integer_dtype(dtype):
    k = _jkey(3)
    words = np.asarray(jax.random.key_data(jax.random.split(k, 2)[1]))
    t = torch.from_numpy(words.astype(np.int64)).to(dtype)
    assert np.array_equal(prng.split(t, 4).numpy(),
                          _data(jax.random.split(jax.random.split(k, 2)[1],
                                                 4)))


@pytest.mark.parametrize("layers", [1, 2, 12, 24])
def test_layer_words_equal_the_backbone_split(layers):
    k = _jkey(100 + layers)
    assert np.array_equal(prng.layer_words(np.asarray(k), layers).numpy(),
                          layer_words(k, layers).numpy())


def test_batched_keys_split_along_the_last_axis():
    keys = jax.random.split(_jkey(9), 6)
    got = prng.split(np.asarray(jax.random.key_data(keys)), 3).numpy()
    for i in range(6):
        assert np.array_equal(got[i], _data(jax.random.split(keys[i], 3)))


def test_threefry_known_answer():
    """The Random123 known-answer vector of threefry2x32 with 20 rounds
    (key and counter all ones bits): JAX's own test value."""
    m = prng.MASK32
    x0, x1 = prng.threefry2x32(m, m, m, m)
    assert (x0, x1) == (0x1CB996FC, 0xBB002BE7)
    x0, x1 = prng.threefry2x32(0, 0, 0, 0)
    assert (x0, x1) == (0x6B200159, 0x99BA4EFE)


def _accum_pair(accum, rates):
    kw = dict(GPT_GEOM, fused_head_ce=True, head_ce_chunk=24, **rates)
    jcfg = j_tiny(compute_dtype=jnp.bfloat16, scan_layers=False, **kw)
    tcfg = t_tiny(compute_dtype=torch.bfloat16, **kw)
    j_norms, t_norms = [], []

    def j_post(g):
        jax.debug.callback(lambda n: j_norms.append(float(n)),
                           j_global_norm(g))
        return g

    def t_post(g):
        t_norms.append(float(t_global_norm(g)))
        return g

    params = jax.tree.map(np.asarray,
                          j_init_params(jax.random.PRNGKey(0), jcfg))
    j_init, j_step = j_make(
        lambda p, t, lab, k: j_gpt_loss(p, t, lab, jcfg, dropout_rng=k),
        j_adam(lr=1e-3), "O2", accum_steps=accum, grad_postprocess=j_post)
    t_init, t_step = t_make(
        lambda p, t, lab, k: t_gpt_loss(p, t, lab, tcfg, dropout_rng=k),
        t_adam(lr=1e-3), "O2", accum_steps=accum, grad_postprocess=t_post,
        device="cpu")
    js = j_init(jax.tree.map(jnp.asarray, params))
    js = js._replace(loss_scale_state=JLossScaleState(
        jnp.float32(2.0 ** 15), jnp.int32(0)))
    ts = t_init(params_from_numpy(params, device="cpu"))
    ts = ts._replace(loss_scale_state=LossScaleState(
        torch.tensor(2.0 ** 15), torch.tensor(0, dtype=torch.int32)))
    return (jax.jit(j_step), js), (t_step, ts), (j_norms, t_norms)


@pytest.mark.parametrize("accum", [2, 4])
def test_accum_steps_with_dropout_tracks_jax(hashed_jax, accum):
    rates = dict(hidden_dropout=0.1, attention_dropout=0.1,
                 drop_path_rate=0.1)
    (j_step, js), (t_step, ts), (j_norms, t_norms) = _accum_pair(accum,
                                                                 rates)
    rng = np.random.RandomState(3)
    seq = {"j": [], "t": []}
    for i in range(3):
        tok = rng.randint(0, GPT_GEOM["vocab_size"], (4, 32)).astype(np.int32)
        lab = rng.randint(0, GPT_GEOM["vocab_size"], (4, 32)).astype(np.int32)
        key = jax.random.PRNGKey(50 + i)
        js, jm = j_step(js, jnp.asarray(tok), jnp.asarray(lab), key)
        ts, tm = t_step(ts, torch.from_numpy(tok).long(),
                        torch.from_numpy(lab).long(), _raw_key(key))
        for name, m in (("j", jm), ("t", tm)):
            seq[name].append((float(m["loss"]), bool(m["overflow"]),
                              float(m["loss_scale"])))
    jl = np.array([s[0] for s in seq["j"]])
    tl = np.array([s[0] for s in seq["t"]])
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    assert [s[1:] for s in seq["t"]] == [s[1:] for s in seq["j"]]
    live = [i for i, s in enumerate(seq["t"]) if not s[1]]
    assert live
    for i in live:
        assert abs(t_norms[i] - j_norms[i]) <= NORM_RTOL * j_norms[i]


def test_raw_key_equals_its_derived_words_bit_for_bit():
    """One step fed a raw key equals the step fed the [L, 5, 2] words JAX
    derives from it (the backbone's split), bit for bit: the port derives
    the same words."""
    rates = dict(hidden_dropout=0.1, attention_dropout=0.1)
    (_, _), (t_step, ts), _ = _accum_pair(1, rates)
    rng = np.random.RandomState(4)
    tok = torch.from_numpy(rng.randint(0, 256, (2, 32))).long()
    key = jax.random.PRNGKey(77)
    _, m_key = t_step(ts, tok, tok, torch.from_numpy(_data(key)))
    _, m_words = t_step(ts, tok, tok, layer_words(key, GPT_GEOM["num_layers"]))
    assert torch.equal(m_key["loss"], m_words["loss"])


@pytest.mark.parametrize("last", ["int64 labels", "uint32 key"])
def test_accum_splits_data_and_rekeys_only_a_uint32_key(last):
    """Under accum_steps=2 a trailing [2] int64 tensor is batch data, cut
    into one row per microbatch; only [2] uint32 words (JAX's raw key
    layout) are re-keyed, microbatch i taking split(key, 2)[i].  As the
    JAX step, which recognizes a raw key only as a (2,) uint32 leaf."""
    seen = []

    def loss_fn(p, x, tail):
        seen.append(tail.clone())
        return (p["w"].float() * x.float()).sum()

    init, step = t_make(loss_fn, t_adam(lr=1e-3), "O2", accum_steps=2,
                        device="cpu")
    state = init({"w": torch.ones(3)})
    x = torch.ones(2, 3)
    if last == "uint32 key":
        tail = _raw_key(_jkey(9))
        want = [torch.from_numpy(np.array(k)) for k in
                jax.random.key_data(jax.random.split(_jkey(9), 2))]
    else:
        tail = torch.tensor([5, 6], dtype=torch.int64)
        want = [tail[:1], tail[1:]]
    step(state, x, tail)
    assert len(seen) == 2
    for got, w in zip(seen, want):
        assert got.dtype == w.dtype and torch.equal(got, w)
