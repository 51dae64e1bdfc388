"""Generic attention masks through the port's model, routed as the JAX
package's ``_core_attention`` (``apex_tpu/models/transformer_lm.py:
464-502``): a 2-D mask is key padding, any other mask (``[b, 1, sq, sk]``,
``[b, n, sq, sk]``) takes the materialized-score path through
``scaled_masked_softmax`` under both attention backends, OR-ed with the
causal triangle in a causal model.  ``gpt_forward`` logits and
``gpt_loss`` with its gradients against the JAX package at fp32 (2
layers, h64, s16, parameters carried across by ``params_from_numpy``),
within 1e-5 relative to each tensor's largest value.  And a
``flash_attention(mask=...)`` call on a tensor the router takes for a
CUDA one runs ``mha_reference``, as the JAX package does on every
device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import transformer_lm as jlm
from apex_tpu.models.config import gpt_tiny as j_tiny
from apex_tpu.ops import flash_attention as jfa
from apex_tpu_torch.models import transformer_lm as tlm
from apex_tpu_torch.models.config import gpt_tiny as t_tiny
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.ops import flash_attention as tfa

B, S, NH, V = 2, 16, 4, 128
GEOM = dict(num_layers=2, hidden_size=64, num_attention_heads=NH,
            vocab_size=V, max_position_embeddings=S)
TOL = 1e-5


def _setup(backend, mask_type, mask_shape, seed=0):
    jcfg = j_tiny(compute_dtype=jnp.float32, attention_backend=backend,
                  attn_mask_type=mask_type, scan_layers=False, **GEOM)
    tcfg = t_tiny(compute_dtype=torch.float32, attention_backend=backend,
                  attn_mask_type=mask_type, **GEOM)
    jp = jlm.init_gpt_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(seed + 1)
    tok = rng.randint(0, V, (B, S)).astype(np.int32)
    lab = rng.randint(0, V, (B, S)).astype(np.int32)
    mask = rng.rand(*mask_shape) < 0.3
    if len(mask_shape) == 4:
        mask[0, ..., 3, :] = True         # a fully masked query row
    return jcfg, tcfg, jp, tp, tok, lab, mask


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-6))


MASKS = [(B, 1, S, S), (B, NH, S, S)]


@pytest.mark.parametrize("mask_shape", MASKS, ids=["b1ss", "bnss"])
@pytest.mark.parametrize("mask_type", ["causal", "padding"])
@pytest.mark.parametrize("backend", ["flash", "fused_softmax"])
def test_gpt_forward_with_a_generic_mask_matches_jax(backend, mask_type,
                                                     mask_shape):
    jcfg, tcfg, jp, tp, tok, _, mask = _setup(backend, mask_type,
                                              mask_shape)
    want = jlm.gpt_forward(jp, jnp.asarray(tok), jcfg,
                           attention_mask=jnp.asarray(mask))
    got = tlm.gpt_forward(tp, torch.from_numpy(tok).long(), tcfg,
                          attention_mask=torch.from_numpy(mask))
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("mask_shape", MASKS, ids=["b1ss", "bnss"])
@pytest.mark.parametrize("mask_type", ["causal", "padding"])
@pytest.mark.parametrize("backend", ["flash", "fused_softmax"])
def test_gpt_loss_gradients_with_a_generic_mask_match_jax(
        backend, mask_type, mask_shape):
    jcfg, tcfg, jp, tp, tok, lab, mask = _setup(backend, mask_type,
                                                mask_shape, seed=2)
    jloss, jgrad = jax.value_and_grad(
        lambda p: jlm.gpt_loss(p, jnp.asarray(tok), jnp.asarray(lab), jcfg,
                               attention_mask=jnp.asarray(mask)))(jp)
    leaves = {k: v.requires_grad_(True) for k, v in tp["layers"].items()}
    tp["embedding"]["word"].requires_grad_(True)
    loss = tlm.gpt_loss(tp, torch.from_numpy(tok).long(),
                        torch.from_numpy(lab).long(), tcfg,
                        attention_mask=torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    for name, leaf in leaves.items():
        assert _rel(leaf.grad.numpy(), jgrad["layers"][name]) <= TOL, name
    assert _rel(tp["embedding"]["word"].grad.numpy(),
                jgrad["embedding"]["word"]) <= TOL


def test_a_b1ss_mask_and_two_d_masks_still_take_flash(monkeypatch):
    """A [2, 1, 16, 16] mask under both backends (it once failed in an
    einsum that took every mask for key padding), and a [b, sk] mask
    under flash still reaches ``flash_attention`` as key padding."""
    for backend in ("flash", "fused_softmax"):
        jcfg, tcfg, jp, tp, tok, _, mask = _setup(backend, "causal",
                                                  (2, 1, 16, 16), seed=4)
        want = jlm.gpt_forward(jp, jnp.asarray(tok), jcfg,
                               attention_mask=jnp.asarray(mask))
        got = tlm.gpt_forward(tp, torch.from_numpy(tok).long(), tcfg,
                              attention_mask=torch.from_numpy(mask))
        assert _rel(got.numpy(), want) <= TOL
    calls = []
    real = tlm.flash_attention

    def spy(*a, **kw):
        calls.append(kw.get("key_padding_mask"))
        return real(*a, **kw)

    jcfg, tcfg, jp, tp, tok, _, _ = _setup("flash", "padding", (B, S))
    kpm = np.zeros((B, S), bool)
    kpm[1, 11:] = True
    monkeypatch.setattr(tlm, "flash_attention", spy)
    got = tlm.gpt_forward(tp, torch.from_numpy(tok).long(), tcfg,
                          attention_mask=torch.from_numpy(kpm))
    assert len(calls) == 2 and all(c is not None for c in calls)
    want = jlm.gpt_forward(jp, jnp.asarray(tok), jcfg,
                           attention_mask=jnp.asarray(kpm))
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("kind", ["mask", "bias"])
def test_flash_attention_with_mask_on_cuda_runs_mha_reference(monkeypatch,
                                                              kind):
    """The router sees a CUDA tensor (``on_cuda`` patched): a call with
    ``mask=`` or ``bias=`` runs the torch composition, as the JAX package
    runs ``mha_reference`` on every device, and does not raise."""
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 8, 4, 16).astype(np.float32) for _ in range(3))
    extra = (rng.rand(2, 4, 8, 8) < 0.3 if kind == "mask"
             else rng.randn(2, 1, 8, 8).astype(np.float32))
    kw = {kind: extra}
    monkeypatch.setattr(tfa, "on_cuda", lambda t: True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=True,
                              **{kind: torch.from_numpy(extra)})
    plain = tfa.mha_reference(tq, tk, tv, causal=True,
                              **{kind: torch.from_numpy(extra)})
    assert torch.equal(got, plain)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True,
                               **{kind: jnp.asarray(a)
                                  for kind, a in kw.items()})
    assert _rel(got.numpy(), want) <= TOL
