"""Data- and context-parallel GPT training of the port against the JAX
package, on one spawned gloo world of 4 ranks (dp = 2 × sp = 2).

- The loss and gradients of ``gpt_loss`` under ``mesh_ctx(mesh,
  seq_axis="sp", context_parallel="ring" | "ulysses")``, each rank's
  gradients averaged over dp × sp, against JAX's single-device
  ``value_and_grad(gpt_loss)`` with ``TestContextParallelGPT``'s config
  (tests/test_ring_attention.py:232-238): rtol 2e-5 on the loss, 5e-4 on
  the gradients (that test's tolerances).
- Three O2 steps of ``make_gpt_train_step(mesh, seq_axis="sp",
  context_parallel=...)`` from one converted JAX state against JAX's
  single-device O2 step on the same batches (the losses within 3e-2, the
  O2 tolerance of tests/torch_train_cases.py), and against the port's
  single-process O2 step (losses and grad norms within 1e-3: the same
  math in another order).
- On the ring, hidden dropout and drop-path (each rank's slice of the
  global masks), and the degraded gathered path (attention dropout, a key
  padding mask; one warning a process, ``APEX_TPU_CP_STRICT=1`` raises)
  against JAX's single-device ``value_and_grad(gpt_loss)`` on the same
  key and mask, its hidden-dropout and drop-path masks drawn by the
  port's counter hash (the ``hashed_jax`` patch of
  tests/test_torch_train_dropout.py): rtol 2e-5 on the loss, 5e-4 on the
  gradients; and against the port's single-process ``gpt_loss`` with the
  same key words: loss rtol 1e-5, gradients atol 1e-5 (fp32, the same
  masks).
- The refusals: the JAX step's (padding mask, attention dropout, Ulysses
  head counts) and the later slices' (tp, pp, ep, FSDP, overlap_comm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.gpt import make_gpt_train_step as j_make
from apex_tpu.models.transformer_lm import gpt_loss as j_gpt_loss
from apex_tpu.optimizers import fused_adam as j_adam
from apex_tpu_torch.models.config import TransformerConfig
from apex_tpu_torch.models.convert import (
    params_from_numpy, train_state_from_jax)
from apex_tpu_torch.models.gpt import make_gpt_train_step
from apex_tpu_torch.models.transformer_lm import gpt_loss
from apex_tpu_torch.parallel import create_mesh
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.optimizers._common import float_leaves
from test_torch_train_dropout import _j_drop_path, _j_dropout, layer_words
from torch_dist_cases import World
from torch_train_cases import one_torch_thread, oracle_jit  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DP, SP = 2, 2
B, S = 2, 64
STEPS = 3
MODES = ("ring", "ulysses")


DROP_KEY = 3         # jax.random.PRNGKey of the dropout cases
DROPOUT_CASES = {"hidden": dict(hidden_dropout=0.1, drop_path_rate=0.1),
                 "attention": dict(attention_dropout=0.1),
                 "padding": dict(attn_mask_type="padding")}


def _jcfg(dtype, **kw):
    return JConfig(num_layers=2, hidden_size=64, num_attention_heads=4,
                   vocab_size=128, max_position_embeddings=64,
                   compute_dtype=dtype, **kw)


def _batches(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 128, (B, S)).astype(np.int32),
             rng.randint(0, 128, (B, S)).astype(np.int32))
            for _ in range(n)]


@pytest.fixture(scope="module")
def inputs():
    """The JAX package's parameters, O2 state and batches (numpy)."""
    from apex_tpu.models.transformer_lm import init_gpt_params

    params = init_gpt_params(jax.random.PRNGKey(0), _jcfg(jnp.float32))
    (tok, lab), = _batches(0, 1)
    lab[0, :5] = -1                  # ignored positions count globally
    j_init, _ = j_make(_jcfg(jnp.bfloat16), j_adam(lr=1e-3), "O2")
    kpm = np.zeros((B, S), bool)
    kpm[0, -7:] = True               # padded keys of the first row
    words = layer_words(jax.random.PRNGKey(DROP_KEY), 2).numpy()
    return dict(params=jax.tree.map(np.asarray, params), tokens=tok,
                labels=lab, kpm=kpm, words=words,
                o2_state=jax.tree.map(np.asarray,
                                      j_init(jax.random.PRNGKey(1))),
                o2_batches=_batches(1, STEPS))


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """The spawned world, started here; the JAX oracles below run while
    it works."""
    return World("cp_gpt", DP * SP, dict(inputs, dp=DP, sp=SP),
                 tmp_path_factory.mktemp("cp_gpt"))


@pytest.fixture(scope="module")
def oracle_grads(inputs, world):
    """JAX's single-device loss and gradients."""
    cfg = _jcfg(jnp.float32)
    params = jax.tree.map(jnp.asarray, inputs["params"])
    loss, grads = oracle_jit(jax.value_and_grad(j_gpt_loss),
                             static_argnums=3)(
        params, jnp.asarray(inputs["tokens"]), jnp.asarray(inputs["labels"]),
        cfg)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def oracle_dropout(inputs, world):
    """JAX's single-device fp32 loss and gradients of each dropout case,
    its hidden-dropout and drop-path masks drawn by the port's counter
    hash (attention dropout is the flash kernels' hash on both sides)."""
    from apex_tpu.models import transformer_lm as jtlm

    params = jax.tree.map(jnp.asarray, inputs["params"])
    batch = (jnp.asarray(inputs["tokens"]), jnp.asarray(inputs["labels"]))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtlm, "_dropout", _j_dropout)
        mp.setattr(jtlm, "_drop_path", _j_drop_path)
        for name, kw in DROPOUT_CASES.items():
            cfg = _jcfg(jnp.float32, scan_layers=False, **kw)
            if name == "padding":
                extra = dict(attention_mask=jnp.asarray(inputs["kpm"]))
            else:
                extra = dict(dropout_rng=jax.random.PRNGKey(DROP_KEY))
            loss, grads = oracle_jit(jax.value_and_grad(
                lambda p, t, lb, e, cfg=cfg: j_gpt_loss(p, t, lb, cfg, **e)))(
                params, *batch, extra)
            out[name] = (float(loss), jax.tree.map(np.asarray, grads))
    return out


@pytest.fixture(scope="module")
def oracle_o2(inputs, world):
    """JAX's single-device O2 losses on the same state and batches."""
    _, j_step = j_make(_jcfg(jnp.bfloat16), j_adam(lr=1e-3), "O2")
    j_step = oracle_jit(j_step)
    jstate = jax.tree.map(jnp.asarray, inputs["o2_state"])
    losses = []
    for t, lb in inputs["o2_batches"]:
        jstate, m = j_step(jstate, jnp.asarray(t), jnp.asarray(lb))
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def single_o2(inputs):
    """The port's single-process O2 step on the same state and batches."""
    cfg = TransformerConfig(num_layers=2, hidden_size=64,
                            num_attention_heads=4, vocab_size=128,
                            max_position_embeddings=64,
                            compute_dtype=torch.bfloat16)
    _, step = make_gpt_train_step(cfg, fused_adam(lr=1e-3), "O2",
                                  device="cpu", norm_telemetry=True)
    state = train_state_from_jax(inputs["o2_state"], device="cpu")
    seq = []
    for t, lb in inputs["o2_batches"]:
        state, m = step(state, t, lb)
        seq.append((float(m["loss"]), bool(m["overflow"]),
                    float(m["grad_norm"])))
    return seq


@pytest.mark.parametrize("mode", MODES)
def test_loss_and_grads_match_single_device_jax(world, oracle_grads, mode):
    loss, grads = oracle_grads
    want = [np.asarray(x.float()) for x in float_leaves(
        params_from_numpy(grads, device="cpu"))]
    for r in range(DP * SP):
        got = world.results()[r][mode]
        np.testing.assert_allclose(got["loss"], loss, rtol=2e-5)
        assert len(got["grads"]) == len(want)
        for i, (a, b) in enumerate(zip(got["grads"], want)):
            np.testing.assert_allclose(
                a, b, atol=5e-4, rtol=5e-4,
                err_msg=f"{mode} rank {r} gradient leaf {i}")


@pytest.mark.parametrize("mode", MODES)
def test_o2_steps_track_jax_and_the_single_process_step(world, oracle_o2,
                                                        single_o2, mode):
    ranks = world.results()
    for r in range(DP * SP):
        seq = ranks[r][mode]["o2"]
        assert len(seq) == STEPS
        for t, ((loss, overflow, gnorm), want, (s_loss, s_over, s_gnorm)) in \
                enumerate(zip(seq, oracle_o2, single_o2)):
            assert not overflow and not s_over
            np.testing.assert_allclose(loss, want, rtol=3e-2,
                                       err_msg=f"{mode} rank {r} step {t}")
            np.testing.assert_allclose(loss, s_loss, rtol=1e-3)
            np.testing.assert_allclose(gnorm, s_gnorm, rtol=1e-3)
    # every rank holds the same masters after its steps
    for r in range(1, DP * SP):
        for a, b in zip(ranks[r][mode]["o2_masters"],
                        ranks[0][mode]["o2_masters"]):
            np.testing.assert_array_equal(a, b)


def _single_loss_and_grads(inputs, **kw):
    """The port's single-process fp32 gpt_loss and gradients."""
    extra = kw.pop("extra")
    cfg = TransformerConfig(num_layers=2, hidden_size=64,
                            num_attention_heads=4, vocab_size=128,
                            max_position_embeddings=64,
                            compute_dtype=torch.float32, **kw)
    params = params_from_numpy(inputs["params"], device="cpu")
    leaves = float_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = gpt_loss(params, torch.as_tensor(inputs["tokens"]).long(),
                    torch.as_tensor(inputs["labels"]).long(), cfg, **extra)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("name", list(DROPOUT_CASES))
def test_dropout_and_the_gathered_fallback_match_one_process(
        world, inputs, oracle_dropout, name):
    words = torch.as_tensor(inputs["words"])
    extra = (dict(attention_mask=torch.as_tensor(inputs["kpm"]))
             if name == "padding" else dict(dropout_rng=words))
    loss, grads = _single_loss_and_grads(inputs, extra=extra,
                                         **DROPOUT_CASES[name])
    j_loss, j_grads = oracle_dropout[name]
    j_grads = [np.asarray(x.float()) for x in float_leaves(
        params_from_numpy(j_grads, device="cpu"))]
    np.testing.assert_allclose(loss, j_loss, rtol=2e-5)
    for r, ranks in enumerate(world.results()):
        got = ranks["dropout"]
        np.testing.assert_allclose(got[name]["loss"], j_loss, rtol=2e-5)
        np.testing.assert_allclose(got[name]["loss"], loss, rtol=1e-5)
        assert len(got[name]["grads"]) == len(j_grads)
        for i, (a, b, c) in enumerate(zip(got[name]["grads"], j_grads,
                                          grads)):
            np.testing.assert_allclose(a, b, atol=5e-4, rtol=5e-4,
                                       err_msg=f"{name} rank {r} leaf {i}")
            np.testing.assert_allclose(a, c, atol=1e-5, rtol=1e-5,
                                       err_msg=f"{name} rank {r} leaf {i}")
        # attention dropout and the mask took the gathered path: one
        # warning a process; the strict variable makes it an error
        assert got["warnings"] == 1 and got["strict_raised"]


@pytest.mark.parametrize("kw, exc, match", [
    (dict(mesh=dict(tp=2)), NotImplementedError, "tensor-parallel slice"),
    (dict(mesh=dict(pp=2)), NotImplementedError, "pipeline slice"),
    (dict(mesh=dict(ep=2)), NotImplementedError, "EP island"),
    (dict(mesh=dict(dp=2), fsdp=True), NotImplementedError, "FSDP slice"),
    (dict(mesh=dict(dp=2), overlap_comm=True), NotImplementedError,
     "tensor-parallel slice"),
    (dict(mesh=dict(sp=2), seq_axis="sp", context_parallel="ring",
          cfg=dict(attn_mask_type="padding")), ValueError, "padding"),
    (dict(mesh=dict(sp=2), seq_axis="sp", context_parallel="ring",
          cfg=dict(attention_dropout=0.1)), ValueError, "attention_dropout"),
    (dict(mesh=dict(sp=8), seq_axis="sp", context_parallel="ulysses"),
     ValueError, "divisible"),
])
def test_refusals(kw, exc, match):
    """The layout of each mesh is enough: the step raises before it asks
    for a process group."""
    shape = kw.pop("mesh")
    cfg = TransformerConfig(num_layers=2, hidden_size=64,
                            num_attention_heads=4, vocab_size=128,
                            max_position_embeddings=64,
                            **kw.pop("cfg", {}))
    mesh = create_mesh(ranks=list(range(int(np.prod(list(shape.values()))))),
                       **shape)
    with pytest.raises(exc, match=match):
        make_gpt_train_step(cfg, fused_adam(lr=1e-3), "O2", mesh,
                            device="cpu", **kw)
