"""O1/O4 per-op casts of the port (``apex_tpu_torch/amp/patch.py``,
``amp/lists.py``) on the CPU: the cases of tests/test_amp_patch.py over
torch, the cast-list decorators, and the O1 and O4 steps against the JAX
package's.

The scope: matmul-class torch functions run in the compute dtype inside
it and not after it, the fp32 class casts 16-bit inputs up, non-float
arguments pass, ``@`` is not patched (as ``x @ w`` is not in JAX), the
scope is exception-safe, re-entrant and per thread, and the port's ops
run unpatched inside.  The steps: O1 and O4 on ``bench.py``'s MLP
(``bench_mlp_adam``, 2 layers of 256 off the TPU) and on a two-layer GPT
step in lockstep with JAX's for 6 steps: losses within 3e-2 (the bf16
and fp16 rounding of tests/torch_train_cases.py's O2 bound; the MLP's
fp32 products within 1e-5, its masters within 1e-5 absolute after 4
Adam steps of lr 1e-3), identical scaler decisions, and an overflowed O1
step keeps every master bit for bit."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu.amp.frontend import make_train_step as j_make_train
from apex_tpu.models.config import gpt_tiny as j_tiny
from apex_tpu.models.gpt import make_gpt_train_step as j_make
from apex_tpu.optimizers import fused_adam as j_adam
from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp.frontend import make_train_step as t_make_train
from apex_tpu_torch.amp.patch import (
    PATCHED_COMPUTE, PATCHED_FP32, active_dtype, amp_patch_scope)
from apex_tpu_torch.models.config import gpt_tiny as t_tiny
from apex_tpu_torch.models.convert import (
    params_from_numpy, train_state_from_jax)
from apex_tpu_torch.models.gpt import make_gpt_train_step as t_make
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.optimizers import fused_adam as t_adam
from apex_tpu_torch.optimizers import fused_sgd as t_sgd

LOSS_TOL = 3e-2
MLP_TOL = 1e-5
MASTER_ATOL = 1e-5      # 1% of one Adam step at lr 1e-3: fp16 gradients
                        # near zero round apart and Adam normalizes them


class TestPatchScope:
    def test_matmul_casts_down_inside_scope(self):
        a = torch.ones(4, 4)
        with amp_patch_scope(torch.bfloat16):
            out = torch.matmul(a, a)
            lin = F.linear(a, a)
            ein = torch.einsum("ij,jk->ik", a, a)
        assert out.dtype == lin.dtype == ein.dtype == torch.bfloat16
        assert torch.matmul(a, a).dtype == torch.float32   # restored

    def test_softmax_casts_up_inside_scope(self):
        x = torch.ones(4, 4, dtype=torch.bfloat16)
        with amp_patch_scope(torch.bfloat16):
            out = torch.softmax(x, -1)
            g = F.gelu(x)
        assert out.dtype == g.dtype == torch.float32
        assert torch.softmax(x, -1).dtype == torch.bfloat16   # restored

    def test_operator_matmul_is_not_patched(self):
        a = torch.ones(4, 4)
        with amp_patch_scope(torch.float16):
            assert (a @ a).dtype == torch.float32
            assert a.matmul(a).dtype == torch.float32

    def test_exception_safe_restore(self):
        try:
            with amp_patch_scope():
                raise RuntimeError("boom")
        except RuntimeError:
            pass
        assert active_dtype() is None
        a = torch.ones(2, 2)
        assert torch.matmul(a, a).dtype == torch.float32

    def test_reentrant(self):
        a = torch.ones(2, 2)
        with amp_patch_scope(torch.bfloat16):
            with amp_patch_scope(torch.float16):
                inner = torch.matmul(a, a)
            # inner exit must not unpatch the outer scope
            out2 = torch.matmul(a, a)
        assert inner.dtype == torch.float16
        assert out2.dtype == torch.bfloat16
        assert torch.matmul(a, a).dtype == torch.float32

    def test_non_float_args_pass_through(self):
        with amp_patch_scope(torch.bfloat16):
            out = torch.cumsum(torch.arange(4), 0)
            i = torch.matmul(torch.ones(2, 2, dtype=torch.int64),
                             torch.ones(2, 2, dtype=torch.int64))
        assert out.dtype == i.dtype == torch.int64

    def test_per_thread(self):
        a = torch.ones(2, 2)
        inside, release = threading.Event(), threading.Event()
        seen = {}

        def scoped():
            with amp_patch_scope(torch.float16):
                seen["scoped"] = torch.matmul(a, a).dtype
                inside.set()
                release.wait(10)

        t = threading.Thread(target=scoped)
        t.start()
        assert inside.wait(10)
        seen["other"] = torch.matmul(a, a).dtype
        release.set()
        t.join()
        assert seen == {"scoped": torch.float16, "other": torch.float32}

    def test_port_ops_run_unpatched_inside(self):
        x = torch.randn(4, 16)
        w = torch.ones(16)
        with amp_patch_scope(torch.float16):
            y = fused_layer_norm(x, w, torch.zeros(16))
            assert active_dtype() == torch.float16
        assert y.dtype == torch.float32
        torch.testing.assert_close(y, fused_layer_norm(x, w, torch.zeros(16)))

    def test_lists_cover_the_jax_classes(self):
        assert {torch.matmul, torch.einsum, torch.outer, F.linear} \
            <= PATCHED_COMPUTE
        assert {torch.softmax, F.gelu, torch.exp, torch.cumsum} \
            <= PATCHED_FP32
        assert "einsum" in lists.FP16_FUNCS and "gelu" in lists.FP32_FUNCS
        assert "where" in lists.CASTS


@pytest.mark.parametrize("deco, want", [
    (lists.half_function, torch.float16),
    (lists.bfloat16_function, torch.bfloat16),
    (lists.float_function, torch.float32)])
def test_cast_decorators(deco, want):
    @deco
    def f(x, pair, idx, scale=None):
        return x.dtype, pair[0].dtype, pair[1].dtype, idx.dtype, scale.dtype

    got = f(torch.ones(2, dtype=torch.bfloat16),
            (torch.ones(2), torch.ones(2, dtype=torch.float16)),
            torch.arange(2), scale=torch.ones(1, dtype=torch.float64))
    assert got == (want, want, want, torch.int64, want)


def test_promote_function():
    @lists.promote_function
    def f(a, b):
        return a.dtype, b.dtype

    assert f(torch.ones(1, dtype=torch.bfloat16),
             torch.ones(1, dtype=torch.float16)) == (torch.float32,) * 2
    assert f(torch.ones(1, dtype=torch.float16),
             torch.ones(1, dtype=torch.float16)) == (torch.float16,) * 2
    assert f(torch.ones(1, dtype=torch.float16),
             torch.arange(2))[1] == torch.int64


@pytest.mark.parametrize("level, want", [("O1", torch.float16),
                                         ("O4", torch.bfloat16),
                                         ("O0", torch.float32)])
def test_step_matmuls_run_in_the_compute_dtype(level, want):
    """Inside an O1/O4 step the user's (undecorated) torch.matmul runs in
    the compute dtype; O0 keeps fp32 (tests/test_amp_patch.py)."""
    seen = {}

    def loss_fn(p, x):
        y = torch.matmul(x, p["w"])
        seen.setdefault("dtype", y.dtype)
        return torch.mean(torch.softmax(y, -1) ** 2)

    init, step = t_make_train(loss_fn, t_sgd(lr=0.1), level, device="cpu")
    step(init({"w": torch.ones(8, 8)}), torch.ones(2, 8))
    assert seen["dtype"] == want


def _mlp_problem():
    d, layers = 256, 2          # bench_mlp_adam off the TPU
    rng = np.random.RandomState(0)
    params = {f"w{i}": (rng.randn(d, d) * 0.02).astype(np.float32)
              for i in range(layers)}
    x = rng.randn(64, d).astype(np.float32)
    return params, x, layers


def _j_mlp_loss(layers):
    def loss_fn(p, x):
        h = x
        for i in range(layers):
            h = jnp.tanh(h @ p[f"w{i}"].astype(h.dtype))
        return jnp.mean(h ** 2)
    return loss_fn


def _t_mlp_loss(layers):
    def loss_fn(p, x):
        h = x
        for i in range(layers):
            h = torch.tanh(h @ p[f"w{i}"].to(h.dtype))
        return torch.mean(h ** 2)
    return loss_fn


@pytest.mark.parametrize("level", ["O1", "O4"])
def test_bench_mlp_steps_track_jax(level):
    params, x, layers = _mlp_problem()
    j_init, j_step = j_make_train(_j_mlp_loss(layers), j_adam(lr=1e-3),
                                  level)
    t_init, t_step = t_make_train(_t_mlp_loss(layers), t_adam(lr=1e-3),
                                  level, device="cpu")
    js = j_init({k: jnp.asarray(v) for k, v in params.items()})
    ts = t_init(params_from_numpy(params, device="cpu"))
    for _ in range(4):
        js, jm = j_step(js, jnp.asarray(x))
        ts, tm = t_step(ts, torch.from_numpy(x))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= MLP_TOL
        assert (bool(tm["overflow"]), float(tm["loss_scale"])) == \
            (bool(jm["overflow"]), float(jm["loss_scale"]))
    for k in params:
        np.testing.assert_allclose(ts.master_params[k].numpy(),
                                   np.asarray(js.master_params[k]),
                                   rtol=0, atol=MASTER_ATOL)


GEOM = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=256, max_position_embeddings=32)


@pytest.mark.parametrize("level, kw", [
    ("O1", dict(fused_head_ce=True, head_ce_chunk=24)),
    ("O1", dict(attention_backend="fused_softmax")),
    ("O4", dict(fused_head_ce=True, head_ce_chunk=24)),
    ("O4", dict(position_embedding_type="rope", activation="swiglu"))],
    ids=["O1-fused_head", "O1-fused_softmax", "O4-fused_head",
         "O4-rope_swiglu"])
def test_gpt_step_tracks_jax(level, kw):
    g = dict(GEOM, **kw)
    jcfg = j_tiny(compute_dtype=jnp.bfloat16, scan_layers=False, **g)
    tcfg = t_tiny(compute_dtype=torch.bfloat16, **g)
    j_init, j_step = j_make(jcfg, j_adam(lr=1e-3), level)
    j_step = jax.jit(j_step)
    jstate = j_init(jax.random.PRNGKey(0))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    _, t_step = t_make(tcfg, t_adam(lr=1e-3), level, device="cpu")
    rng = np.random.RandomState(2)
    seq = {"j": [], "t": []}
    for _ in range(6):
        tok = rng.randint(0, 256, (2, 32)).astype(np.int32)
        lab = rng.randint(0, 256, (2, 32)).astype(np.int32)
        prev = [v.clone() for v in tstate.master_params["layers"].values()]
        jstate, jm = j_step(jstate, jnp.asarray(tok), jnp.asarray(lab))
        tstate, tm = t_step(tstate, torch.from_numpy(tok),
                            torch.from_numpy(lab))
        if bool(tm["overflow"]):
            for a, b in zip(prev, tstate.master_params["layers"].values()):
                assert torch.equal(a, b)
        for k, m in (("j", jm), ("t", tm)):
            seq[k].append((float(m["loss"]), bool(m["overflow"]),
                           float(m["loss_scale"])))
    np.testing.assert_allclose([s[0] for s in seq["t"]],
                               [s[0] for s in seq["j"]], atol=LOSS_TOL,
                               rtol=0)
    assert [s[1:] for s in seq["t"]] == [s[1:] for s in seq["j"]]
    assert not all(s[1] for s in seq["t"]), "every step overflowed"
    assert tstate.master_params["layers"]["qkv_kernel"].dtype == \
        torch.float32
