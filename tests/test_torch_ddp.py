"""Data-parallel training and gradient communication of the port against
the JAX package, on one spawned gloo world of 2 ranks (dp = 2), plus the
single-process pieces (bucket plans, the launcher's environment table,
the mesh's errors).

- ``make_ddp_train_step`` (fp32 wire) and ``amp.make_train_step(
  axis_name="dp", grad_comm="fp32")`` against JAX's
  ``make_ddp_train_step`` on a 2-device mesh: 3 O0 FusedAdam steps of a
  two-layer tanh MLP (JAX's DDP step differentiates under ``shard_map``,
  where the GPT layers' custom VJPs refuse the varying-axes typing on
  this JAX; the data-parallel GPT runs in
  tests/test_torch_context_parallel.py); losses rtol 1e-5, masters atol
  1e-5 (fp32 both sides).
- ``grad_comm="bf16"`` and ``"int8"`` (error feedback) against the same
  fp32 JAX step within the wire's error (JAX's own compressed DDP step
  refuses its out_specs' replication on this JAX): losses rtol 1e-3;
  masters atol 3e-3, steps × lr, since Adam moves a coordinate whose tiny
  gradient the wire rounds by up to lr a step; the int8 state carries
  one nonzero residual per float leaf.
- One ``compressed_allreduce`` with a residual against JAX's under
  ``shard_map``: reduced values and the new residual atol 1e-6.
- ``compressed_reduce_scatter`` likewise; ``DistributedDataParallel``,
  ``Reducer`` and ``clip_grad_norm(group=)`` against numpy over every
  rank's gradients.
- ``plan_buckets`` equal to JAX's; ``distributed_env`` on
  tests/test_launch.py's cases; ``create_mesh``'s errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import comm as j_comm
from apex_tpu.optimizers import fused_adam as j_adam
from apex_tpu.parallel.distributed import make_ddp_train_step as j_ddp
from apex_tpu.parallel.mesh import create_mesh as j_create_mesh
from apex_tpu_torch import comm
from apex_tpu_torch.parallel import create_mesh, distributed_env
from torch_dist_cases import World

DP = 2
B, STEPS = 8, 3
LR = 1e-3
WIRES = ("ddp", "fp32", "bf16", "int8")
FLAT = 1000


def _mlp_loss(params, x, y):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return jnp.mean((h @ params["w2"] + params["b2"] - y) ** 2)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    params = {"w1": rng.randn(16, 300) * 0.3, "b1": rng.randn(300) * 0.1,
              "w2": rng.randn(300, 8) * 0.1, "b2": np.zeros(8)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    batches = [(rng.randn(B, 16).astype(np.float32),
                rng.randn(B, 8).astype(np.float32)) for _ in range(STEPS)]
    flat = (rng.randn(DP, FLAT) * np.logspace(-3, 1, FLAT)).astype(
        np.float32)
    residual = (rng.randn(DP, FLAT) * 1e-3).astype(np.float32)
    return dict(params=params, batches=batches, flat=flat,
                residual=residual, dp=DP)


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    return World("ddp", DP, inputs, tmp_path_factory.mktemp("ddp"))


def _jax_ddp(inputs):
    mesh = j_create_mesh(dp=DP, devices=jax.devices()[:DP])
    init, step = j_ddp(_mlp_loss, j_adam(lr=LR), "O0", mesh, batch_axes=2)
    state = init(jax.tree.map(jnp.asarray, inputs["params"]))
    losses = []
    for tok, lab in inputs["batches"]:
        state, m = step(state, jnp.asarray(tok), jnp.asarray(lab))
        losses.append(float(m["loss"]))
    # the port's leaf order: the parameter dict's own
    masters = [np.asarray(state.master_params[k]) for k in inputs["params"]]
    return losses, masters


@pytest.fixture(scope="module")
def oracle(inputs, world):
    return _jax_ddp(inputs)


@pytest.mark.parametrize("wire", WIRES)
def test_data_parallel_steps_match_jax(world, oracle, wire):
    losses, masters = oracle
    compressed = wire in ("bf16", "int8")
    loss_tol = 1e-3 if compressed else 1e-5
    master_tol = STEPS * LR if compressed else 1e-5
    for r, got in enumerate(world.results()):
        res = got[wire]
        np.testing.assert_allclose(res["losses"], losses, rtol=loss_tol)
        for i, (a, b) in enumerate(zip(res["masters"], masters)):
            np.testing.assert_allclose(a, b, atol=master_tol, rtol=0,
                                       err_msg=f"{wire} rank {r} leaf {i}")
        if wire == "int8":
            assert [c.shape for c in res["comm_state"]] == [
                (1,) + m.shape for m in res["masters"]]
            assert any(np.abs(c).max() > 0 for c in res["comm_state"])
        else:
            assert res["comm_state"] is None


def test_compressed_allreduce_matches_jax(world, inputs):
    mesh = j_create_mesh(dp=DP, devices=jax.devices()[:DP])
    cfg = j_comm.resolve("int8")

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("dp"),) * 2,
                       out_specs=(P("dp"), P("dp")))
    def f(flat, res):
        red, err = j_comm.compressed_allreduce(flat[0], "dp", cfg,
                                               residual=res[0])
        return red[None], err[None]

    red, err = f(jnp.asarray(inputs["flat"]), jnp.asarray(inputs["residual"]))
    mean = inputs["flat"].mean(0)
    for r, got in enumerate(world.results()):
        np.testing.assert_allclose(got["allreduce"]["reduced"],
                                   np.asarray(red)[r], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["allreduce"]["residual"],
                                   np.asarray(err)[r], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["plain_mean"], mean, rtol=1e-6,
                                   atol=1e-7)


def test_compressed_reduce_scatter_matches_jax(world, inputs):
    """The scatter phase alone: this rank's shard of the sum and the new
    residual, against JAX's under ``shard_map``; atol 1e-6."""
    mesh = j_create_mesh(dp=DP, devices=jax.devices()[:DP])
    cfg = j_comm.resolve("int8")
    shard = -(-FLAT // DP)

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("dp"),) * 2,
                       out_specs=(P("dp"), P("dp")))
    def f(flat, res):
        part, err = j_comm.compressed_reduce_scatter(
            flat[0], "dp", cfg, shard_size=shard, residual=res[0])
        return part[None], err[None]

    part, err = f(jnp.asarray(inputs["flat"]),
                  jnp.asarray(inputs["residual"]))
    for r, got in enumerate(world.results()):
        np.testing.assert_allclose(got["reduce_scatter"]["shard"],
                                   np.asarray(part)[r], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["reduce_scatter"]["residual"],
                                   np.asarray(err)[r], atol=1e-6, rtol=0)


def test_ddp_wrapper_reducer_and_group_clip(world):
    """DistributedDataParallel's hooks give the dp mean of every rank's
    local gradients; Reducer(gradient_predivide_factor=2) the same mean;
    clip_grad_norm(group=) the 2-norm and the max over every rank's part
    (rtol 1e-6)."""
    ranks = [got["wrappers"] for got in world.results()]
    mean = [np.mean([w["local"][i] for w in ranks], 0)
            for i in range(len(ranks[0]["local"]))]
    for w in ranks:
        for a, b, c in zip(w["hooked"], w["reducer"], mean):
            np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(b, c, rtol=1e-6, atol=1e-7)
    # each rank's halves of its own gradients: the union is every rank's
    # half r of rank r's local gradient
    parts = np.concatenate([np.concatenate([
        g.reshape(-1)[:(g.size + 1) // 2] if r == 0 else
        g.reshape(-1)[(g.size + 1) // 2:] for g in w["local"]])
        for r, w in enumerate(ranks)])
    for w in ranks:
        np.testing.assert_allclose(w["group_norm"], np.linalg.norm(parts),
                                   rtol=1e-6)
        np.testing.assert_allclose(w["group_inf_norm"],
                                   np.abs(parts).max(), rtol=1e-6)


def test_plan_buckets_match_jax():
    shapes = [((3, 700), "float32"), ((5,), "float32"), ((0, 4), "float32"),
              ((2000,), "bfloat16"), ((40, 40), "float32"), ((7,), "bfloat16")]
    j_leaves = [jax.ShapeDtypeStruct(s, jnp.dtype(d)) for s, d in shapes]
    t_leaves = [torch.empty(s, dtype=getattr(torch, d)) for s, d in shapes]
    for bucket_bytes, align in ((4096, 1), (4096, 256), (1 << 20, 256),
                                (100, 1)):
        want = j_comm.plan_buckets(j_leaves, bucket_bytes, align)
        got = comm.plan_buckets(t_leaves, bucket_bytes, align)
        assert [tuple(b) for b in got] == [tuple(b) for b in want]
        # gather, then scatter, gives every leaf back
        rng = np.random.RandomState(1)
        vals = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
            getattr(torch, d)) for s, d in shapes]
        flats = [comm.gather_bucket(vals, b) for b in got]
        back = comm.scatter_buckets(vals, got, flats)
        for a, b in zip(back, vals):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("env, want", [
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234", "PROCESS_ID": "3",
      "NUM_PROCESSES": "16"}, ("10.0.0.1:1234", 3, 16)),
    ({"MASTER_ADDR": "host0", "MASTER_PORT": "29500", "RANK": "2",
      "WORLD_SIZE": "8"}, ("host0:29500", 2, 8)),
    ({"MASTER_ADDR": "host0", "NODE_RANK": "1", "WORLD_SIZE": "4"},
     ("host0:8476", 1, 4)),
    ({"MASTER_ADDR": "host0", "RANK": "5", "NODE_RANK": "1",
      "WORLD_SIZE": "8"}, ("host0:8476", 5, 8)),
    ({}, (None, None, None)),
    ({"COORDINATOR_ADDRESS": "c:1", "MASTER_ADDR": "m", "PROCESS_ID": "0",
      "RANK": "9", "NUM_PROCESSES": "2", "WORLD_SIZE": "99"},
     ("c:1", 0, 2)),
])
def test_distributed_env_matches_jax(env, want):
    from apex_tpu.parallel.launch import distributed_env as j_env

    assert distributed_env(env) == j_env(env) == want


def test_init_distributed_refusals(monkeypatch):
    from apex_tpu_torch.parallel import init_distributed

    for var in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "RANK", "WORLD_SIZE",
                "PROCESS_ID", "NUM_PROCESSES", "NODE_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() == 1          # one process: nothing opened
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(RuntimeError, match="no coordinator"):
        init_distributed()
    with pytest.raises(ValueError, match="backend"):
        init_distributed("127.0.0.1:1", 2, 0, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        init_distributed("127.0.0.1:1", 2, 0, backend="nccl", device="cpu")
    monkeypatch.delenv("RANK")
    monkeypatch.setenv("MASTER_ADDR", "host0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        init_distributed(num_processes=None)


@pytest.mark.parametrize("kw", [dict(tp=3), dict(dp=3, tp=2),
                                dict(sp=5), dict(dp=2, sp=2, ep=3)])
def test_create_mesh_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        j_create_mesh(**kw)
    with pytest.raises(ValueError) as got:
        create_mesh(ranks=list(range(8)), **kw)
    assert str(got.value) == str(want.value)


def test_create_mesh_layout_matches_jax():
    """The JAX axis order and reshape over the ranks: each axis's lines
    of ranks are those of JAX's device ids."""
    kw = dict(dp=2, sp=2, tp=2)
    jm = j_create_mesh(**kw)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    tm = create_mesh(ranks=list(range(8)), **kw)
    np.testing.assert_array_equal(tm.devices, ids)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.lines("sp") == [list(map(int, row)) for row in
                              np.moveaxis(ids, 2, -1).reshape(-1, 2)]
