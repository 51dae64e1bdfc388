"""The port's BERT (apex_tpu_torch.models.bert) against the JAX package's
on the CPU, from one parameter tree converted through numpy, under both
attention backends ('flash': the plain flash forward and backward;
'fused_softmax': materialized scores through the scaled masked softmax):

- bert_forward's MLM and NSP logits and bert_pretrain_loss at fp32
  compute: both sides compute in fp32 in another order, so 1e-5 relative
  to the largest logit and 1e-5 on the loss;
- the AMP-O2 train step with FusedLAMB stepped 12 times in lockstep with
  make_bert_train_step from one converted JAX TrainState: identical
  overflow and loss-scale sequences (the first step, at a 2**24 scale,
  must overflow), losses within 3e-2, fp32 masters within 2e-2 and LAMB
  moments within 5e-2 of the JAX tree in relative L2 distance (the
  tolerances of tests/torch_train_cases.py: bf16 compute rounds at other
  places in the two frameworks).

The batches are realistic: ragged valid lengths with one full row (and
one row of length 1), about 15% of the real positions carrying MLM
labels, token types split at a per-row boundary, NSP labels 0/1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.scaler import LossScaleState as JLossScaleState
from apex_tpu.models import bert as jbert
from apex_tpu.models.config import bert_large as j_bert_large
from apex_tpu.optimizers import fused_lamb as j_lamb
from apex_tpu_torch.models import bert as tbert
from apex_tpu_torch.models.config import bert_large as t_bert_large
from apex_tpu_torch.models.convert import (
    params_from_numpy, params_to_numpy, train_state_from_jax)
from apex_tpu_torch.optimizers import LambState, fused_lamb as t_lamb
from torch_train_cases import _tree_rel

GEOM = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64)
B, S, STEPS = 3, 48, 12
FWD_TOL = 1e-5
LOSS_TOL, MASTER_TOL, MOMENT_TOL = 3e-2, 2e-2, 5e-2
BACKENDS = ["flash", "fused_softmax"]


def make_batch(vocab, b, s, seed):
    """tokens, mlm_labels, nsp_labels, tokentype_ids, attention_mask (int,
    1 = real token) as numpy int32."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(s // 2, s + 1, b)
    lens[0] = s
    lens[-1] = 1
    am = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
    tokens = rng.randint(0, vocab, (b, s)).astype(np.int32)
    mlm = np.where((rng.rand(b, s) < 0.15) & (am == 1),
                   rng.randint(0, vocab, (b, s)), -1).astype(np.int32)
    nsp = rng.randint(0, 2, b).astype(np.int32)
    split = rng.randint(1, s, b)
    tt = (np.arange(s)[None] >= split[:, None]).astype(np.int32)
    return tokens, mlm, nsp, tt, am


def _cfgs(backend, compute):
    jd, td = dict(fp32=(jnp.float32, torch.float32),
                  bf16=(jnp.bfloat16, torch.bfloat16))[compute]
    jcfg = j_bert_large(attention_backend=backend, compute_dtype=jd,
                        scan_layers=False, **GEOM)
    tcfg = t_bert_large(attention_backend=backend, compute_dtype=td, **GEOM)
    return jcfg, tcfg


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_and_loss_match_jax(backend):
    jcfg, tcfg = _cfgs(backend, "fp32")
    jparams = jbert.init_bert_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    tok, mlm, nsp, tt, am = make_batch(GEOM["vocab_size"], B, S, seed=0)
    jl, jb = jbert.bert_forward(jparams, jnp.asarray(tok), jcfg,
                                tokentype_ids=jnp.asarray(tt),
                                attention_mask=jnp.asarray(am))
    t = [torch.from_numpy(a).long() for a in (tok, mlm, nsp, tt)]
    tl, tb = tbert.bert_forward(tparams, t[0], tcfg, tokentype_ids=t[3],
                                attention_mask=torch.from_numpy(am))
    assert tl.dtype == torch.float32 and tl.shape == (B, S, GEOM[
        "vocab_size"]) and tb.shape == (B, 2)
    assert _rel(tl.numpy(), jl) <= FWD_TOL
    assert _rel(tb.numpy(), jb) <= FWD_TOL
    jloss = jbert.bert_pretrain_loss(
        jparams, jnp.asarray(tok), jnp.asarray(mlm), jnp.asarray(nsp), jcfg,
        tokentype_ids=jnp.asarray(tt), attention_mask=jnp.asarray(am))
    tloss = tbert.bert_pretrain_loss(tparams, *t[:3], tcfg,
                                     tokentype_ids=t[3],
                                     attention_mask=torch.from_numpy(am))
    assert abs(float(tloss) - float(jloss)) <= FWD_TOL


@pytest.mark.parametrize("backend", BACKENDS)
def test_o2_lamb_train_step_tracks_jax(backend):
    jcfg, tcfg = _cfgs(backend, "bf16")
    j_init, j_step = jbert.make_bert_train_step(
        jcfg, j_lamb(lr=1e-3, weight_decay=0.01), "O2")
    jstate = j_init(jax.random.PRNGKey(0))
    jstate = jstate._replace(loss_scale_state=JLossScaleState(
        jnp.float32(2.0 ** 24), jnp.int32(0)))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    assert isinstance(tstate.opt_state, LambState)
    assert tstate.params["embedding"]["word"].dtype == torch.float16
    _, t_step = tbert.make_bert_train_step(
        tcfg, t_lamb(lr=1e-3, weight_decay=0.01), "O2", device="cpu")
    seq = {"j": [], "t": []}
    for i in range(STEPS):
        batch = make_batch(GEOM["vocab_size"], B, S, seed=10 + i)
        jstate, jm = j_step(jstate, *(jnp.asarray(a) for a in batch))
        tstate, tm = t_step(tstate, *(torch.from_numpy(a) for a in batch))
        for key, m in (("j", jm), ("t", tm)):
            seq[key].append((float(m["loss"]), bool(m["overflow"]),
                             float(m["loss_scale"]), int(m["step"])))
    jl = np.array([s[0] for s in seq["j"]])
    tl = np.array([s[0] for s in seq["t"]])
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    assert [s[1:] for s in seq["t"]] == [s[1:] for s in seq["j"]]
    assert seq["t"][0][1], "the 2**24 start scale must overflow"
    assert not seq["t"][-1][1]
    jstate = jax.tree.map(np.asarray, jstate)
    assert int(tstate.opt_state.step) == int(jstate.opt_state.step)
    assert _tree_rel(jstate.master_params, params_to_numpy(
        tstate.master_params)) <= MASTER_TOL
    for name in ("exp_avg", "exp_avg_sq"):
        assert _tree_rel(getattr(jstate.opt_state, name), params_to_numpy(
            getattr(tstate.opt_state, name))) <= MOMENT_TOL, name


def test_padding_mask_and_refusals():
    am = torch.tensor([[1, 1, 0], [1, 0, 0]])
    assert torch.equal(tbert._padding_mask(am), am == 0)
    assert tbert._padding_mask(None) is None
    # remat builds (it raised before); the mesh still raises
    cfg = t_bert_large(remat=True, **GEOM)
    tbert.make_bert_train_step(cfg, t_lamb(), "O2", device="cpu")
    with pytest.raises(NotImplementedError):
        tbert.make_bert_train_step(t_bert_large(**GEOM), t_lamb(), "O2",
                                   mesh=object(), device="cpu")
