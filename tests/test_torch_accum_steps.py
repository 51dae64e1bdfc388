"""fp32 main-grad accumulation in the port's AMP step
(apex_tpu_torch.amp.make_train_step(accum_steps=...)) against the JAX
package's on the CPU: the cases of tests/test_amp.py's
TestMainGradAccumulation (O5 bf16 accumulation against an fp32 full-batch
step, the accumulated gradient against a hand sum of the microbatches'
fp32 gradients, an overflowed O2 step kept bit for bit), the divisibility
error, the loss as the microbatches' mean and aux from the last one, and
the GPT O2 step with accum_steps=4 against JAX's.

The linear problem is fp32 arithmetic on bf16-rounded weights on both
sides: masters and gradients within 1e-6 absolute, 1e-5 relative of
JAX's; the oracle comparison keeps the JAX suite's 5e-3 / 5e-2.  The GPT
step runs bf16 matmuls, which round at other places in the two
frameworks: losses within 3e-2 (tests/torch_train_cases.py), identical
scaler decisions."""

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
from apex_tpu.optimizers import fused_sgd as j_sgd
from apex_tpu_torch.amp import make_train_step as t_make
from apex_tpu_torch.amp.scaler import LossScaleState
from apex_tpu_torch.models.config import gpt_tiny as t_tiny
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.models.transformer_lm import gpt_loss as t_gpt_loss
from apex_tpu_torch.optimizers import fused_adam as t_adam
from apex_tpu_torch.optimizers import fused_sgd as t_sgd
from torch_train_cases import GEOM

ATOL, RTOL = 1e-6, 1e-5


def _problem(b=16):
    rng = np.random.RandomState(0)
    params = {"w": (rng.randn(12, 8) * 0.3).astype(np.float32),
              "b": np.zeros((8,), np.float32)}
    x = rng.randn(b, 12).astype(np.float32)
    y = rng.randn(b, 8).astype(np.float32)
    return params, x, y


def j_loss(p, x, y):
    return jnp.mean((x @ p["w"].astype(x.dtype) + p["b"].astype(x.dtype)
                     - y) ** 2)


def t_loss(p, x, y):
    return torch.mean((x @ p["w"].to(x.dtype) + p["b"].to(x.dtype) - y) ** 2)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _close(got, want, atol=ATOL, rtol=RTOL):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                   np.asarray(want[k], np.float32),
                                   atol=atol, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("level", ["O5", "O2"])
def test_accum_matches_jax_and_the_fp32_full_batch_step(level):
    params, x, y = _problem()
    j_init, j_step = j_make(j_loss, j_sgd(lr=1e-2), level, accum_steps=4)
    js0 = j_init(_j(params))
    if level == "O2":           # a scale fp16 gradients survive
        js0 = js0._replace(loss_scale_state=JLossScaleState(
            jnp.float32(2.0 ** 10), jnp.int32(0)))
    js, jm = j_step(js0, jnp.asarray(x), jnp.asarray(y))
    t_init, t_step = t_make(t_loss, t_sgd(lr=1e-2), level, accum_steps=4,
                            device="cpu")
    ts0 = t_init(_t(params))
    if level == "O2":
        ts0 = ts0._replace(loss_scale_state=LossScaleState(
            torch.tensor(2.0 ** 10), torch.tensor(0, dtype=torch.int32)))
    ts, tm = t_step(ts0, torch.from_numpy(x), torch.from_numpy(y))
    assert bool(tm["overflow"]) == bool(jm["overflow"]) is False
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _close({k: v.numpy() for k, v in ts.master_params.items()},
           js.master_params)
    # the fp32 oracle: one full-batch O0 step (the JAX suite's tolerance)
    r_init, r_step = t_make(t_loss, t_sgd(lr=1e-2), "O0", device="cpu")
    ref, _ = r_step(r_init(_t(params)), torch.from_numpy(x),
                    torch.from_numpy(y))
    _close({k: v.numpy() for k, v in ts.master_params.items()},
           {k: v.numpy() for k, v in ref.master_params.items()},
           atol=5e-3, rtol=5e-2)


def test_accum_equals_manual_fp32_sum():
    """The accumulated gradient is the fp32 sum of the microbatches'
    gradients over 4, JAX's captured gradient within 1e-6."""
    params, x, y = _problem()
    captured = {}

    def t_capture(grads):
        captured["t"] = {k: v.clone() for k, v in grads.items()}
        return grads

    def j_capture(grads):
        captured["j"] = grads
        return grads

    t_init, t_step = t_make(t_loss, t_sgd(lr=1e-2), "O5", accum_steps=4,
                            grad_postprocess=t_capture, device="cpu")
    t_step(t_init(_t(params)), torch.from_numpy(x), torch.from_numpy(y))
    j_init, j_step = j_make(j_loss, j_sgd(lr=1e-2), "O5", accum_steps=4,
                            grad_postprocess=j_capture)
    j_step(j_init(_j(params)), jnp.asarray(x), jnp.asarray(y))
    manual = {k: torch.zeros(v.shape) for k, v in params.items()}
    for i in range(4):
        p = {k: torch.from_numpy(v).bfloat16().requires_grad_()
             for k, v in params.items()}
        loss = t_loss(p, torch.from_numpy(x[i * 4:(i + 1) * 4]),
                      torch.from_numpy(y[i * 4:(i + 1) * 4]))
        for k, g in zip(p, torch.autograd.grad(loss, list(p.values()))):
            manual[k] = manual[k] + g.float()
    manual = {k: v / 4.0 for k, v in manual.items()}
    _close({k: v.numpy() for k, v in captured["t"].items()},
           {k: v.numpy() for k, v in manual.items()})
    _close({k: v.numpy() for k, v in captured["t"].items()}, captured["j"])


def test_overflow_skip_with_accum():
    params, x, y = _problem()
    bad = x.copy()
    bad[0, 0] = np.inf
    t_init, t_step = t_make(t_loss, t_sgd(lr=1e-2), "O2", accum_steps=4,
                            device="cpu")
    s0 = t_init(_t(params))
    s1, m = t_step(s0, torch.from_numpy(bad), torch.from_numpy(y))
    j_init, j_step = j_make(j_loss, j_sgd(lr=1e-2), "O2", accum_steps=4)
    _, jm = j_step(j_init(_j(params)), jnp.asarray(bad), jnp.asarray(y))
    assert bool(m["overflow"]) and bool(jm["overflow"])
    for k in params:
        assert torch.equal(s1.master_params[k], s0.master_params[k])
    assert float(m["loss_scale"]) == float(jm["loss_scale"])


def test_indivisible_batch_raises_and_aux_is_the_last_microbatch():
    params, x, y = _problem(b=16)
    t_init, t_step = t_make(t_loss, t_sgd(lr=1e-2), "O0", accum_steps=3,
                            device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        t_step(t_init(_t(params)), torch.from_numpy(x), torch.from_numpy(y))

    def with_aux(p, x, y):
        return t_loss(p, x, y), x[0, 0]

    t_init, t_step = t_make(with_aux, t_sgd(lr=1e-2), "O0", accum_steps=4,
                            has_aux=True, device="cpu")
    _, m = t_step(t_init(_t(params)), torch.from_numpy(x),
                  torch.from_numpy(y))
    assert float(m["aux"]) == float(x[12, 0])
    losses = [float(t_loss(_t(params), torch.from_numpy(x[i:i + 4]),
                           torch.from_numpy(y[i:i + 4])))
              for i in range(0, 16, 4)]
    assert float(m["loss"]) == pytest.approx(np.mean(losses), rel=1e-6)


def test_gpt_o2_accum_steps_tracks_jax():
    """The GPT O2 step with FusedAdam on the AMP step at accum_steps=4
    (b8 as 4 microbatches of 2), 3 steps from one set of parameters."""
    kw = dict(GEOM, fused_head_ce=True, head_ce_chunk=24)
    jcfg = j_tiny(compute_dtype=jnp.bfloat16, scan_layers=False, **kw)
    tcfg = t_tiny(compute_dtype=torch.bfloat16, **kw)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    j_init, j_step = j_make(lambda p, t, lab: j_gpt_loss(p, t, lab, jcfg),
                            j_adam(lr=1e-3), "O2", accum_steps=4)
    j_step = jax.jit(j_step)
    t_init, t_step = t_make(lambda p, t, lab: t_gpt_loss(p, t, lab, tcfg),
                            t_adam(lr=1e-3), "O2", accum_steps=4,
                            device="cpu")
    js = j_init(jp)
    js = js._replace(loss_scale_state=JLossScaleState(jnp.float32(2.0 ** 15),
                                                      jnp.int32(0)))
    ts = t_init(tp)
    ts = ts._replace(loss_scale_state=LossScaleState(
        torch.tensor(2.0 ** 15), torch.tensor(0, dtype=torch.int32)))
    rng = np.random.RandomState(0)
    for _ in range(3):
        tok = rng.randint(0, GEOM["vocab_size"], (8, 32)).astype(np.int32)
        lab = rng.randint(0, GEOM["vocab_size"], (8, 32)).astype(np.int32)
        js, jm = j_step(js, jnp.asarray(tok), jnp.asarray(lab))
        ts, tm = t_step(ts, torch.from_numpy(tok).long(),
                        torch.from_numpy(lab).long())
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 3e-2
        assert (bool(tm["overflow"]), float(tm["loss_scale"])) == (
            bool(jm["overflow"]), float(jm["loss_scale"]))
        assert not bool(tm["overflow"])
