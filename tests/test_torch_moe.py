"""The port's MoE FFN (``apex_tpu_torch/transformer/moe.py``) against the
JAX package's ``apex_tpu.transformer.moe.switch_moe_mlp`` at fp32, on
seeded numpy parameters carried across by ``params_from_numpy``: both
routings, top-k 1 and 2, a capacity factor of 0.5 that drops tokens,
gelu and gelu_tanh.  Forward outputs within 1e-5; the aux loss within
fp32 rounding of a mean taken in another order; ``dropped_fraction`` and
``expert_load`` equal.  Gradients (x, router, fc1, fc2 and both biases)
against ``jax.vjp`` within 1e-5.  The quantized experts (int8 slabs,
ragged routing) against their fake-quant tree, and the argument checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.grouped_matmul import (
    _dequantize_group as j_deq, quantize_group_weights as j_qgw)
from apex_tpu.transformer import moe as jmoe
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.ops import grouped_matmul as tgm
from apex_tpu_torch.transformer import moe as tmoe

B, S, H, F, E = 2, 16, 64, 96, 4
TOL = 1e-5
KEYS = ("router", "fc1", "fc1_bias", "fc2", "fc2_bias")


def _case(seed=0):
    rng = np.random.RandomState(seed)
    p = {"router": rng.randn(H, E) * 0.5,
         "fc1": rng.randn(E, H, F) * 0.1,
         "fc1_bias": rng.randn(E, F) * 0.1,
         "fc2": rng.randn(E, F, H) * 0.1,
         "fc2_bias": rng.randn(E, H) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.randn(B, S, H).astype(np.float32)
    return p, x


def _t(p, x):
    return params_from_numpy(p, device="cpu"), torch.from_numpy(x)


@pytest.mark.parametrize("routing, factor, top_k, activation", [
    ("capacity", 1.25, 1, "gelu"), ("capacity", 1.25, 2, "gelu_tanh"),
    ("capacity", 0.5, 1, "gelu_tanh"), ("capacity", 0.5, 2, "gelu"),
    ("ragged", 1.25, 1, "gelu"), ("ragged", 1.25, 2, "gelu"),
    ("ragged", 1.25, 1, "gelu_tanh")])
def test_switch_moe_matches_jax(routing, factor, top_k, activation):
    p, x = _case()
    kw = dict(capacity_factor=factor, top_k=top_k, activation=activation,
              routing=routing)
    want = jmoe.switch_moe_mlp(jax.tree.map(jnp.asarray, p),
                               jnp.asarray(x), **kw)
    tp, tx = _t(p, x)
    got = tmoe.switch_moe_mlp(tp, tx, **kw)
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-6)
    assert float(got.dropped_fraction) == float(want.dropped_fraction)
    np.testing.assert_array_equal(got.expert_load.numpy(),
                                  np.asarray(want.expert_load))
    if routing == "ragged":
        assert float(got.dropped_fraction) == 0.0
    if factor == 0.5:
        assert float(got.dropped_fraction) > 0.0   # tokens really drop


@pytest.mark.parametrize("routing, factor, top_k", [
    ("capacity", 1.25, 1), ("capacity", 0.5, 2), ("ragged", 1.25, 1),
    ("ragged", 1.25, 2)])
def test_switch_moe_gradients_match_jax_vjp(routing, factor, top_k):
    """d(Σ out·c + 3·aux) for x and every parameter: the gates' and the
    router's paths, the dispatch, the grouped matmul's dx and dw."""
    p, x = _case(1)
    rng = np.random.RandomState(2)
    cot = rng.randn(B, S, H).astype(np.float32)
    kw = dict(capacity_factor=factor, top_k=top_k, routing=routing)

    def jfn(xx, *leaves):
        o = jmoe.switch_moe_mlp(dict(zip(KEYS, leaves)), xx, **kw)
        return jnp.sum(o.out * cot) + 3.0 * o.aux_loss

    jgrads = jax.grad(jfn, argnums=tuple(range(6)))(
        jnp.asarray(x), *(jnp.asarray(p[k]) for k in KEYS))
    tp, tx = _t(p, x)
    tx.requires_grad_(True)
    for v in tp.values():
        v.requires_grad_(True)
    o = tmoe.switch_moe_mlp(tp, tx, **kw)
    (torch.sum(o.out * torch.from_numpy(cot)) + 3.0 * o.aux_loss).backward()
    got = [tx.grad] + [tp[k].grad for k in KEYS]
    for name, g, w in zip(("x",) + KEYS, got, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_ragged_combine_is_deterministic_and_drop_free():
    """top-k 2: the k slots of a token are summed through the inverse
    permutation in slot order, so two runs agree bit for bit."""
    p, x = _case(3)
    tp, tx = _t(p, x)
    a = tmoe.switch_moe_mlp(tp, tx, routing="ragged", top_k=2)
    b = tmoe.switch_moe_mlp(tp, tx, routing="ragged", top_k=2)
    assert torch.equal(a.out, b.out)
    assert float(a.expert_load.sum()) == 2 * B * S


def test_sorted_assignment_offsets_match_bincount():
    rng = np.random.RandomState(4)
    choice = torch.from_numpy(rng.randint(0, 6, (40, 2)))
    gates = torch.from_numpy(rng.rand(40, 2).astype(np.float32))
    order, inv, offsets, gate_s = tmoe._sorted_assignment(choice, gates, 7)
    np.testing.assert_array_equal(order.numpy()[inv.numpy()], np.arange(80))
    counts = np.bincount(choice.numpy().ravel(), minlength=7)
    np.testing.assert_array_equal(
        offsets.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    # the stable order of jnp.argsort
    np.testing.assert_array_equal(
        order.numpy(), np.asarray(jnp.argsort(jnp.asarray(choice.numpy())
                                              .reshape(-1))))
    np.testing.assert_array_equal(gate_s.numpy(),
                                  gates.numpy().reshape(-1)[order.numpy()])


def test_topk_routing_ties_go_to_the_first_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    choice, gates = tmoe._topk_routing(probs, 2)
    jc, jg = jmoe._topk_routing(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(choice.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(gates.numpy(), np.asarray(jg))


def test_init_moe_params_shapes():
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe_params(gen, 32, 64, 4, device="cpu")
    want = jmoe.init_moe_params(jax.random.PRNGKey(0), 32, 64, 4)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert float(p["fc1_bias"].abs().sum()) == 0.0
    sw = tmoe.init_moe_params(gen, 32, 64, 4, activation="swiglu",
                              device="cpu")
    assert tuple(sw["fc1"].shape) == (4, 32, 128)


def test_router_noise_comes_from_the_callers_generator():
    p, x = _case(5)
    tp, tx = _t(p, x)
    runs = [tmoe.switch_moe_mlp(
        tp, tx, routing="ragged",
        router_noise_generator=torch.Generator().manual_seed(s)).out
        for s in (7, 7)]
    assert torch.equal(runs[0], runs[1])


def _quantized_case(seed=13, block=16):
    p, x = _case(seed)
    tp, tx = _t(p, x)
    qp = dict(tp, fc1=tgm.quantize_group_weights(tp["fc1"], block),
              fc2=tgm.quantize_group_weights(tp["fc2"], block))
    fq = dict(tp, fc1=tgm._dequantize_group(qp["fc1"]["wire"],
                                            qp["fc1"]["scale"]),
              fc2=tgm._dequantize_group(qp["fc2"]["wire"],
                                        qp["fc2"]["scale"]))
    return p, x, tx, qp, fq


@pytest.mark.parametrize("top_k", [1, 2])
def test_quantized_slabs_match_fake_quant(top_k):
    """tests/test_quantized_matmul.py's TestQuantizedMoE on the port, and
    the JAX package's quantized MoE on the same wire and scales."""
    p, x, tx, qp, fq = _quantized_case()
    out_q = tmoe.switch_moe_mlp(qp, tx, routing="ragged", top_k=top_k)
    out_fq = tmoe.switch_moe_mlp(fq, tx, routing="ragged", top_k=top_k)
    np.testing.assert_allclose(out_q.out.numpy(), out_fq.out.numpy(),
                               atol=1e-5, rtol=1e-5)
    assert float(out_q.dropped_fraction) == 0.0
    jq = dict(jax.tree.map(jnp.asarray, p),
              fc1=j_qgw(jnp.asarray(p["fc1"]), 16),
              fc2=j_qgw(jnp.asarray(p["fc2"]), 16))
    want = jmoe.switch_moe_mlp(jq, jnp.asarray(x), routing="ragged",
                               top_k=top_k, ep_axis=None)
    np.testing.assert_allclose(out_q.out.numpy(), np.asarray(want.out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(
        np.asarray(jq["fc1"]["wire"]), qp["fc1"]["wire"].numpy())
    np.testing.assert_array_equal(np.asarray(j_deq(
        jq["fc2"]["wire"], jq["fc2"]["scale"])), fq["fc2"].numpy())


def test_quantized_slabs_need_ragged_routing_and_no_mesh():
    _, _, tx, qp, _ = _quantized_case()
    with pytest.raises(ValueError, match="routing='ragged'"):
        tmoe.switch_moe_mlp(qp, tx, routing="capacity")
    with pytest.raises(ValueError, match="single-device serving"):
        tmoe.switch_moe_mlp(qp, tx, routing="ragged", ep_mesh=object())


def test_argument_checks_and_the_distributed_slice():
    p, x = _case()
    tp, tx = _t(p, x)
    with pytest.raises(ValueError, match="routing="):
        tmoe.switch_moe_mlp(tp, tx, routing="dense")
    with pytest.raises(ValueError, match="moe_comm="):
        tmoe.switch_moe_mlp(tp, tx, routing="ragged", moe_comm="fp8")
    with pytest.raises(NotImplementedError, match="distributed-training"):
        tmoe.switch_moe_mlp(tp, tx, routing="ragged", ep_mesh=object())
    with pytest.raises(NotImplementedError, match="distributed-training"):
        tmoe.switch_moe_mlp(tp, tx, routing="ragged", overlap_comm=True)
    # ep_axis with no mesh (and no overlap) is the local math
    a = tmoe.switch_moe_mlp(tp, tx, routing="ragged", ep_axis="ep")
    b = tmoe.switch_moe_mlp(tp, tx, routing="ragged", ep_axis=None)
    assert torch.equal(a.out, b.out)
    # swiglu experts are ported (they raised before): fc1
    # is the 2f-wide [gate ‖ up]; the JAX comparison is
    # tests/test_torch_swiglu.py
    sw = tmoe.init_moe_params(torch.Generator().manual_seed(1), H, F, E,
                              activation="swiglu", device="cpu")
    for routing in ("ragged", "capacity"):
        o = tmoe.switch_moe_mlp(sw, tx, routing=routing, activation="swiglu")
        assert o.out.shape == tx.shape and torch.isfinite(o.out).all()


def test_dropped_fraction_gauge():
    from apex_tpu_torch.observability import metrics

    p, x = _case()
    tp, tx = _t(p, x)
    reg = metrics.configure()
    try:
        tmoe.switch_moe_mlp(tp, tx, routing="ragged")
        assert reg.summary()["gauges"]["moe.dropped_fraction"] == 0.0
    finally:
        metrics.shutdown()


def test_quantized_moe_model_matches_jax_and_carries_across():
    """``quantize_params`` of an MoE GPT: the expert slabs per layer, bit
    for bit the JAX package's (compared after the JAX tree crosses
    through ``params_from_numpy`` with no renaming), the same
    ``param_bytes``; the quantized ragged forward's logits against the
    JAX quantized forward and the port's own fake-quant tree."""
    from apex_tpu.models import quantized as jq
    from apex_tpu.models import transformer_lm as jlm
    from apex_tpu.models.config import gpt_tiny as j_tiny
    from apex_tpu_torch.models import quantized as tq
    from apex_tpu_torch.models import transformer_lm as tlm
    from apex_tpu_torch.models.config import gpt_tiny as t_tiny

    geom = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                vocab_size=128, max_position_embeddings=16, num_experts=4,
                moe_routing="ragged", moe_top_k=2)
    jcfg = j_tiny(compute_dtype=jnp.float32, scan_layers=False, **geom)
    tcfg = t_tiny(compute_dtype=torch.float32, **geom)
    jp = jlm.init_gpt_params(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert set(tp["layers"]) == set(jp["layers"])
    assert "fc1_kernel" not in tp["layers"]
    jqp = jq.quantize_params(jp, block=32)
    tqp = tq.quantize_params(tp, block=32)
    carried = params_from_numpy(jax.tree.map(np.asarray, jqp), device="cpu")
    for name in ("moe_fc1", "moe_fc2", "qkv_kernel", "proj_kernel"):
        for part in ("wire", "scale"):
            np.testing.assert_array_equal(tqp["layers"][name][part].numpy(),
                                          carried["layers"][name][part]
                                          .numpy())
    assert carried["layers"]["moe_fc1"]["wire"].dtype == torch.int8
    assert not tq.is_quantized_tree(tp) and tq.is_quantized_tree(tqp)
    assert tq.param_bytes(tqp) == jq.param_bytes(jqp)
    with pytest.raises(ValueError, match="already quantized"):
        tq.quantize_params(tqp)
    tok = np.random.RandomState(4).randint(0, 128, (2, 16)).astype(np.int32)
    want = jlm.gpt_forward(jqp, jnp.asarray(tok), jcfg)
    got = tlm.gpt_forward(tqp, torch.from_numpy(tok).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    fq = tlm.gpt_forward(tq.dequantize_params(tqp),
                         torch.from_numpy(tok).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), fq.numpy(), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="routing='ragged'"):
        tlm.gpt_forward(tqp, torch.from_numpy(tok).long(),
                        t_tiny(compute_dtype=torch.float32,
                               **dict(geom, moe_routing="capacity")))


def test_bert_stays_dense():
    from apex_tpu_torch.models import bert as tbert
    from apex_tpu_torch.models.config import bert_large

    cfg = bert_large(num_layers=1, hidden_size=32, num_attention_heads=2,
                     vocab_size=64, num_experts=4)
    with pytest.raises(NotImplementedError, match="dense encoder"):
        tbert.init_bert_params(cfg, device="cpu")
