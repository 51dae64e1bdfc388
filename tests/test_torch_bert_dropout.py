"""The port's BERT O2 + FusedLAMB step with hidden and attention dropout
(0.1 and 0.1, BERT-large's published rates) in lockstep with the JAX
package's over 3 steps, under attention_backend="flash" (the flash
kernels' dropout) and "fused_softmax" (dropout on the materialized
probabilities): the masks, the hooks, the keys and the tolerances of
tests/test_torch_train_dropout.py."""

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
from apex_tpu_torch.models.convert import train_state_from_jax
from apex_tpu_torch.optimizers import fused_lamb as t_lamb
from test_torch_bert import make_batch
from test_torch_train_dropout import (  # noqa: F401  (hashed_jax: fixture)
    BERT_GEOM, STEPS, _check, _lockstep, _norm_hooks, hashed_jax)
from torch_train_cases import one_torch_thread, oracle_jit  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("backend", ["flash", "fused_softmax"])
def test_bert_o2_lamb_dropout_step_tracks_jax(hashed_jax, backend):
    kw = dict(BERT_GEOM, attention_backend=backend, hidden_dropout=0.1,
              attention_dropout=0.1)
    jcfg = j_bert_large(compute_dtype=jnp.bfloat16, scan_layers=False, **kw)
    tcfg = t_bert_large(compute_dtype=torch.bfloat16, **kw)
    j_norms, t_norms, j_post, t_post = _norm_hooks()
    j_init, j_step = jbert.make_bert_train_step(
        jcfg, j_lamb(lr=1e-3, weight_decay=0.01), "O2",
        grad_postprocess=j_post)
    j_step = oracle_jit(j_step)
    jstate = j_init(jax.random.PRNGKey(0))
    jstate = jstate._replace(loss_scale_state=JLossScaleState(
        jnp.float32(2.0 ** 15), jnp.int32(0)))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    _, t_step = tbert.make_bert_train_step(
        tcfg, t_lamb(lr=1e-3, weight_decay=0.01), "O2", device="cpu",
        grad_postprocess=t_post)
    batches = [make_batch(BERT_GEOM["vocab_size"], 3, 48, seed=10 + i)
               for i in range(STEPS)]
    seq = _lockstep(j_step, t_step, jstate, tstate, batches,
                    BERT_GEOM["num_layers"])
    _check(seq, j_norms, t_norms)


@pytest.mark.parametrize("backend", ["flash", "fused_softmax"])
def test_bert_dropout_loss_matches_jax_fp32(hashed_jax, backend):
    """One fp32 forward with both sites dropping: the pretraining loss
    within 1e-5 of JAX's."""
    from apex_tpu_torch.models.convert import params_from_numpy
    from test_torch_train_dropout import layer_words

    kw = dict(BERT_GEOM, attention_backend=backend, hidden_dropout=0.1,
              attention_dropout=0.1)
    jcfg = j_bert_large(compute_dtype=jnp.float32, scan_layers=False, **kw)
    tcfg = t_bert_large(compute_dtype=torch.float32, **kw)
    jp = jbert.init_bert_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tok, mlm, nsp, tt, am = make_batch(BERT_GEOM["vocab_size"], 3, 48, 5)
    key = jax.random.PRNGKey(3)

    def j_loss(p, a, b, c, t_, m, k):
        return jbert.bert_pretrain_loss(p, a, b, c, jcfg, tokentype_ids=t_,
                                        attention_mask=m, dropout_rng=k)

    want = float(oracle_jit(j_loss)(
        jp, *(jnp.asarray(x) for x in (tok, mlm, nsp, tt, am)), key))
    t = [torch.from_numpy(a).long() for a in (tok, mlm, nsp, tt)]
    got = float(tbert.bert_pretrain_loss(
        tp, *t[:3], tcfg, tokentype_ids=t[3],
        attention_mask=torch.from_numpy(am),
        dropout_rng=layer_words(key, BERT_GEOM["num_layers"])))
    assert abs(got - want) <= 1e-5
