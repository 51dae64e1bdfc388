"""``remat=True`` in the port (``models/transformer_lm.transformer_backbone``:
each layer under ``torch.utils.checkpoint``, the counterpart of the JAX
package's ``jax.checkpoint(body)``) on the CPU.

- Remat against no remat, bit for bit: two O2 steps from one state give
  the same losses, scaler decisions, masters and moments exactly, for a
  dense GPT, with every dropout site on (the recompute redraws its masks
  from the same key words), for the MoE FFN under capacity and ragged
  routing (the recompute reaches the same routing), and under O1's
  per-op casts (the recompute runs inside the scope again).
- The remat step against JAX's remat step (``scan_layers=False``) for 4
  steps from one converted state: losses within 3e-2 and identical
  scaler decisions (tests/torch_train_cases.py's O2 bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.scaler import LossScaleState as JLossScaleState
from apex_tpu.models.config import gpt_tiny as j_tiny
from apex_tpu.models.gpt import make_gpt_train_step as j_make
from apex_tpu.optimizers import fused_adam as j_adam
from apex_tpu_torch.amp.scaler import LossScaleState
from apex_tpu_torch.models.config import gpt_tiny as t_tiny
from apex_tpu_torch.models.convert import train_state_from_jax
from apex_tpu_torch.models.gpt import make_gpt_train_step as t_make
from apex_tpu_torch.optimizers import fused_adam as t_adam
from apex_tpu_torch.utils import prng
from torch_train_cases import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GEOM = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=256, max_position_embeddings=32)
LOSS_TOL = 3e-2
STEPS = 2


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for x in tree for v in _leaves(x)]
    return [tree] if torch.is_tensor(tree) else []


def _run(cfg, level, batches, drops, seed=0):
    init, step = t_make(cfg, t_adam(lr=1e-3), level, device="cpu")
    state = init(torch.Generator().manual_seed(seed))
    state = state._replace(loss_scale_state=LossScaleState(
        torch.tensor(2.0 ** 15), torch.tensor(0, dtype=torch.int32)))
    out = []
    for i, (tok, lab) in enumerate(batches):
        rest = (prng.key(1000 + i),) if drops else ()
        state, m = step(state, tok, lab, *rest)
        out.append((m["loss"], bool(m["overflow"]), float(m["loss_scale"])))
    return out, state


def _batches(vocab, b=2, s=32, seed=0):
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(rng.randint(0, vocab, (b, s))).long(),
             torch.from_numpy(rng.randint(0, vocab, (b, s))).long())
            for _ in range(STEPS)]


CASES = {
    "dense": dict(),
    "dropout": dict(hidden_dropout=0.1, attention_dropout=0.1,
                    drop_path_rate=0.1),
    "moe_capacity": dict(num_experts=4, moe_routing="capacity", moe_top_k=2),
    "moe_ragged": dict(num_experts=4, moe_routing="ragged", moe_top_k=2),
    "moe_ragged_dropout": dict(num_experts=4, moe_routing="ragged",
                               hidden_dropout=0.1, attention_dropout=0.1),
    "swiglu_rope": dict(activation="swiglu", position_embedding_type="rope",
                        num_query_groups=2),
}


@pytest.mark.parametrize("case,level", [(c, "O2") for c in CASES]
                         + [("dense", "O1"), ("dropout", "O1")])
def test_remat_equals_no_remat_bit_for_bit(case, level):
    kw = dict(GEOM, fused_head_ce=True, head_ce_chunk=24, **CASES[case])
    drops = "dropout" in case
    batches = _batches(GEOM["vocab_size"])
    got = {}
    for remat in (False, True):
        cfg = t_tiny(compute_dtype=torch.bfloat16, remat=remat, **kw)
        got[remat] = _run(cfg, level, batches, drops)
    (seq0, st0), (seq1, st1) = got[False], got[True]
    assert [s[1:] for s in seq0] == [s[1:] for s in seq1]
    for a, b in zip(seq0, seq1):
        assert torch.equal(a[0], b[0])
    assert not all(s[1] for s in seq0), "every step overflowed"
    for a, b in zip(_leaves(st0), _leaves(st1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused_head", [False, True])
def test_remat_step_tracks_jax_remat(fused_head):
    kw = dict(GEOM, fused_head_ce=fused_head, head_ce_chunk=24, remat=True)
    jcfg = j_tiny(compute_dtype=jnp.bfloat16, scan_layers=False, **kw)
    tcfg = t_tiny(compute_dtype=torch.bfloat16, **kw)
    j_init, j_step = j_make(jcfg, j_adam(lr=1e-3), "O2")
    j_step = jax.jit(j_step)
    jstate = j_init(jax.random.PRNGKey(0))
    jstate = jstate._replace(loss_scale_state=JLossScaleState(
        jnp.float32(2.0 ** 17), jnp.int32(0)))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    _, t_step = t_make(tcfg, t_adam(lr=1e-3), "O2", device="cpu")
    rng = np.random.RandomState(1)
    seq = {"j": [], "t": []}
    for _ in range(4):
        tok = rng.randint(0, 256, (2, 32)).astype(np.int32)
        lab = rng.randint(0, 256, (2, 32)).astype(np.int32)
        jstate, jm = j_step(jstate, jnp.asarray(tok), jnp.asarray(lab))
        tstate, tm = t_step(tstate, torch.from_numpy(tok),
                            torch.from_numpy(lab))
        for k, m in (("j", jm), ("t", tm)):
            seq[k].append((float(m["loss"]), bool(m["overflow"]),
                           float(m["loss_scale"])))
    np.testing.assert_allclose([s[0] for s in seq["t"]],
                               [s[0] for s in seq["j"]], atol=LOSS_TOL,
                               rtol=0)
    assert [s[1:] for s in seq["t"]] == [s[1:] for s in seq["j"]]
    assert not all(s[1] for s in seq["t"]), "every step overflowed"
