"""The port's single-device AMP train step (apex_tpu_torch.models.gpt.
make_gpt_train_step) against the JAX package's, from one converted
state, on the same numpy batches, for 20 steps.

O0 (fp32 params and compute) must track JAX to 1e-4 in the loss; O2
(fp16 params from fp32 masters, bf16 compute) to 3e-2, the spread of
bf16 matmul rounding between XLA and torch on the CPU.  Under O2 the
runs start from a loss scale of 2**24, so the first steps overflow in
fp16 and are skipped: the overflow, loss-scale and step sequences must
be identical, not close.  At the end the fp32 masters and the Adam
moments are compared as whole trees, ||port - jax|| / ||jax||: 1e-4 at
O0 (measured ~4e-6), 2e-2 for the masters and 5e-2 for the moments at
O2 (measured 4e-3 and 1e-2).  Per-element bounds would not hold: Adam
moves an element whose gradient is near zero by about lr either way,
and bf16 rounding decides which way."""

import pytest
import torch

from apex_tpu_torch.models.config import gpt_tiny as t_tiny
from apex_tpu_torch.models.gpt import make_gpt_train_step as t_make
from apex_tpu_torch.optimizers import fused_adam as t_adam
from torch_train_cases import GEOM, check_tracks_jax

@pytest.mark.parametrize("fused", [True, False], ids=["fused_ce", "xentropy"])
def test_train_step_tracks_jax(fused):
    check_tracks_jax("O0", fused)


def test_o2_dtype_chain():
    """O2 keeps fp16 params (norm scales too: the norm-name heuristic
    matches no GPT key) beside fp32 masters and fp32 Adam moments."""
    cfg = t_tiny(**GEOM)
    init, _ = t_make(cfg, t_adam(lr=1e-3), "O2", device="cpu")
    state = init(torch.Generator().manual_seed(0))
    assert state.params["layers"]["qkv_kernel"].dtype == torch.float16
    assert state.params["final_ln"]["scale"].dtype == torch.float16
    assert state.master_params["layers"]["ln1_scale"].dtype == torch.float32
    assert state.opt_state.exp_avg["embedding"]["word"].dtype == \
        torch.float32
    assert float(state.loss_scale_state.loss_scale) == 2.0 ** 16


@pytest.mark.parametrize("kw, match", [
    (dict(remat=True), "remat"),
    (dict(hidden_dropout=0.1), "dropout"),
    (dict(attention_dropout=0.1), "dropout"),
    (dict(drop_path_rate=0.1), "dropout"),
])
def test_unported_config_options_raise(kw, match):
    """A dropout config's step called without its trailing key words
    raises TypeError (the JAX step's missing rng argument).  remat is
    ported: its step runs and equals the step without it
    (tests/test_torch_remat.py holds it bit for bit)."""
    cfg = t_tiny(**dict(GEOM, **kw))
    init, step = t_make(cfg, t_adam(lr=1e-3), "O0", device="cpu")
    state = init(torch.Generator().manual_seed(0))
    tok = torch.zeros(1, 8, dtype=torch.long)
    if match == "remat":
        _, m = step(state, tok, tok)
        plain = t_make(t_tiny(**GEOM), t_adam(lr=1e-3), "O0",
                       device="cpu")[1]
        assert torch.equal(m["loss"], plain(state, tok, tok)[1]["loss"])
        return
    with pytest.raises(TypeError, match=match):
        step(state, tok, tok)


def _dropout_step_with_accum():
    """A GPT dropout step on amp.make_train_step with accum_steps=2, called
    with its [L, 5, 2] key words."""
    from apex_tpu_torch.amp import make_train_step
    from apex_tpu_torch.models.transformer_lm import (
        dropout_keys, gpt_loss, init_gpt_params)

    cfg = t_tiny(**dict(GEOM, hidden_dropout=0.1))
    init, step = make_train_step(
        lambda p, t, lab, w: gpt_loss(p, t, lab, cfg, dropout_rng=w),
        t_adam(lr=1e-3), "O2", accum_steps=2, device="cpu")
    state = init(init_gpt_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu"))
    tok = torch.zeros(2, 8, dtype=torch.long)
    step(state, tok, tok, dropout_keys(cfg, torch.Generator().manual_seed(1),
                                       "cpu"))


@pytest.mark.parametrize("kw, match", [
    (dict(mesh=object()), "distributed"),
    (dict(overlap_comm=True), "overlap_comm"),
    (dict(accum_steps=2), "dropout key words"),
])
def test_unported_step_options_raise(kw, match):
    """The distributed options raise; so does accum_steps > 1 on a step
    whose last argument is dropout key words (JAX splits a threefry key
    there).  norm_telemetry works: tests/test_torch_norm_telemetry.py."""
    with pytest.raises(NotImplementedError, match=match):
        if "accum_steps" in kw:
            _dropout_step_with_accum()
        else:
            t_make(t_tiny(**GEOM), t_adam(lr=1e-3), "O2", device="cpu", **kw)


@pytest.mark.parametrize("level", ["O1", "O4"])
def test_per_op_cast_levels_raise(level):
    """The per-op-cast levels are ported (they raised before): the step
    builds and runs with masters in fp32; the lockstep against JAX is
    tests/test_torch_amp_patch.py."""
    init, step = t_make(t_tiny(**GEOM), t_adam(lr=1e-3), level,
                        device="cpu")
    state = init(torch.Generator().manual_seed(0))
    tok = torch.zeros(1, 8, dtype=torch.long)
    state, m = step(state, tok, tok)
    assert torch.isfinite(m["loss"])
    assert state.master_params["layers"]["qkv_kernel"].dtype == \
        torch.float32
