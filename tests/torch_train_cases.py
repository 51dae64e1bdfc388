"""Shared cases of the port-vs-JAX train-step tests
(tests/test_torch_train_step.py, tests/test_torch_train_step_o2.py): a
two-layer GPT, 20 numpy batches, both packages stepped from one
converted JAX state, and the whole-tree relative distance.  Also the
helpers that keep the port's slow test files cheap: :func:`oracle_jit`
for their JAX oracles and the :func:`one_torch_thread` module fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.scaler import LossScaleState as JLossScaleState
from apex_tpu.models.config import gpt_tiny as j_tiny
from apex_tpu.models.gpt import make_gpt_train_step as j_make
from apex_tpu.optimizers import fused_adam as j_adam
from apex_tpu_torch.models.config import gpt_tiny as t_tiny
from apex_tpu_torch.models.convert import params_to_numpy, train_state_from_jax
from apex_tpu_torch.models.gpt import make_gpt_train_step as t_make
from apex_tpu_torch.optimizers import fused_adam as t_adam

GEOM = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=256, max_position_embeddings=32)
B, S, STEPS = 2, 32, 20
CHUNK = 24          # does not divide the 64 tokens of a batch
LOSS_TOL = {"O0": 1e-4, "O2": 3e-2}
MASTER_TOL = {"O0": 1e-4, "O2": 2e-2}
MOMENT_TOL = {"O0": 1e-4, "O2": 5e-2}


# the JAX oracles' programs compiled by XLA's CPU backend at LLVM -O0:
# the same HLO and the same values (no fast-math at either level), in a
# third less compile time, which dominates these tests
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def oracle_jit(fn, **kw):
    """``jax.jit`` of a JAX oracle (a step, a loss, a probe) with
    :data:`FAST_COMPILE`; an already-jitted ``fn`` compiles as one
    program under these options."""
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread while a module runs (restored after
    it): these tests' tensors are tiny, and idle OpenMP workers spin
    between ops, a third of the tests' CPU time, which the other test
    processes sharing the machine lose."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(vocab, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(STEPS):
        tok = rng.randint(0, vocab, (B, S)).astype(np.int32)
        lab = rng.randint(0, vocab, (B, S)).astype(np.int32)
        lab[0, :5] = -1                      # ignored positions
        yield tok, lab


def _run(opt_level, fused):
    compute = dict(O0=(jnp.float32, torch.float32),
                   O2=(jnp.bfloat16, torch.bfloat16))[opt_level]
    kw = dict(GEOM, fused_head_ce=fused, head_ce_chunk=CHUNK)
    jcfg = j_tiny(compute_dtype=compute[0], scan_layers=False, **kw)
    tcfg = t_tiny(compute_dtype=compute[1], **kw)
    j_init, j_step = j_make(jcfg, j_adam(lr=1e-3), opt_level)
    j_step = oracle_jit(j_step)
    jstate = j_init(jax.random.PRNGKey(0))
    if opt_level == "O2":
        jstate = jstate._replace(loss_scale_state=JLossScaleState(
            jnp.float32(2.0 ** 24), jnp.int32(0)))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    _, t_step = t_make(tcfg, t_adam(lr=1e-3), opt_level, device="cpu")
    seq = {"j": [], "t": []}
    for tok, lab in _batches(GEOM["vocab_size"]):
        jstate, jm = j_step(jstate, jnp.asarray(tok), jnp.asarray(lab))
        tstate, tm = t_step(tstate, torch.from_numpy(tok),
                            torch.from_numpy(lab))
        seq["j"].append((float(jm["loss"]), bool(jm["overflow"]),
                         float(jm["loss_scale"]), int(jm["step"])))
        seq["t"].append((float(tm["loss"]), bool(tm["overflow"]),
                         float(tm["loss_scale"]), int(tm["step"])))
    return seq, jax.tree.map(np.asarray, jstate), tstate


def _flat(tree):
    out = []
    for _, leaf in sorted(tree.items()):
        out += (_flat(leaf) if isinstance(leaf, dict)
                else [np.asarray(leaf, np.float64).ravel()])
    return out


def _tree_rel(want, got):
    """||got - want|| / ||want|| over every leaf of two numpy trees."""
    a, b = np.concatenate(_flat(want)), np.concatenate(_flat(got))
    return float(np.linalg.norm(b - a) / np.linalg.norm(a))


def check_tracks_jax(opt_level, fused):
    """Steps both packages 20 times and holds the port to the module's
    tolerances (tests/test_torch_train_step.py states them)."""
    seq, jstate, tstate = _run(opt_level, fused)
    jl = np.array([s[0] for s in seq["j"]])
    tl = np.array([s[0] for s in seq["t"]])
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL[opt_level], rtol=0)
    # scaler decisions are identical, not close
    assert [s[1:] for s in seq["t"]] == [s[1:] for s in seq["j"]]
    if opt_level == "O2":
        assert seq["t"][0][1], "the 2**24 start scale must overflow"
        assert not seq["t"][-1][1]
    assert int(tstate.step) == int(jstate.step)
    assert int(tstate.opt_state.step) == int(jstate.opt_state.step)
    assert _tree_rel(jstate.master_params, params_to_numpy(
        tstate.master_params)) <= MASTER_TOL[opt_level]
    for name in ("exp_avg", "exp_avg_sq"):
        assert _tree_rel(getattr(jstate.opt_state, name), params_to_numpy(
            getattr(tstate.opt_state, name))) <= MOMENT_TOL[opt_level], name
