"""Spawned gloo worlds for the port's distributed tests
(tests/test_torch_ring_attention.py, tests/test_torch_context_parallel.py,
tests/test_torch_ddp.py).

:class:`World` saves a job's inputs and starts ``world`` processes of
this file (``python tests/torch_dist_cases.py <job> <rank> <world> <port>
<dir>``) on ``device="cpu"`` with the gloo backend; its ``results()``
waits for them and returns each rank's results (:func:`run_world` does
both), so a test module can compute its JAX oracles while the world
runs.  A job is a function of this
module, ``job_<name>(rank, inputs) -> dict``; it imports torch
and the port only (no JAX), so that a worker starts in a few seconds.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class World:
    """``world`` gloo ranks of this file running ``job_<job>``, started
    at construction; :meth:`results` waits for them."""

    def __init__(self, job: str, world: int, inputs: dict, directory,
                 timeout: float = 120.0):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.world, self.timeout, self._results = world, timeout, None
        torch.save(inputs, self.directory / "inputs.pt")
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, job, str(r), str(world), str(port),
             str(self.directory)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(world)]

    def results(self) -> list:
        """Each rank's result dict, by rank; raises with the ranks' output
        when one fails."""
        if self._results is not None:
            return self._results
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in self.procs):
            raise RuntimeError("\n".join(
                f"--- rank {r} (exit {p.returncode}) ---\n{log}"
                for r, (p, log) in enumerate(zip(self.procs, logs))))
        self._results = [torch.load(self.directory / f"out{r}.pt",
                                    weights_only=False)
                         for r in range(self.world)]
        return self._results


def run_world(job: str, world: int, inputs: dict, directory,
              timeout: float = 120.0) -> list:
    """Run ``job_<job>`` on ``world`` gloo ranks and wait: a list of their
    result dicts, by rank."""
    return World(job, world, inputs, directory, timeout).results()


def _np(t):
    return t.detach().float().cpu().numpy()


def _seq_shard(x, mesh, axis="sp", dim=1):
    from apex_tpu_torch.parallel import shard_batch

    return shard_batch(mesh, torch.as_tensor(x), axis=axis, dim=dim)


# ---- jobs -------------------------------------------------------------------


def job_ring(rank, inputs):
    """Ring and Ulysses attention on an sp mesh: for each case, the local
    output and the gradients of ``sum(out · dout)``."""
    from apex_tpu_torch.parallel import (
        create_mesh, ring_attention, ulysses_attention)
    from apex_tpu_torch.utils.collectives import all_gather

    mesh = create_mesh(sp=inputs["sp"])
    group = mesh.group("sp")
    out = {}
    for name, case in inputs["cases"].items():
        q, k, v = (_seq_shard(case[x], mesh).clone().requires_grad_(True)
                   for x in "qkv")
        fn = ulysses_attention if case["mode"] == "ulysses" else \
            ring_attention
        o = fn(q, k, v, group, causal=case["causal"])
        (o * _seq_shard(case["dout"], mesh)).sum().backward()
        # every rank's shards in order along the sequence
        out[name] = {key: _np(all_gather(t.detach(), group, axis=1,
                                         tiled=True))
                     for key, t in (("o", o), ("dq", q.grad),
                                    ("dk", k.grad), ("dv", v.grad))}
    return out


def _tiny_cfg(compute, **kw):
    from apex_tpu_torch.models.config import TransformerConfig

    return TransformerConfig(
        num_layers=2, hidden_size=64, num_attention_heads=4,
        vocab_size=128, max_position_embeddings=64, compute_dtype=compute,
        **kw)


def job_cp_gpt(rank, inputs):
    """The GPT loss and gradients on a dp × sp mesh (ring and Ulysses),
    then three O2 steps of ``make_gpt_train_step`` per mode."""
    from apex_tpu_torch.models.convert import (
        params_from_numpy, train_state_from_jax)
    from apex_tpu_torch.models.gpt import make_gpt_train_step
    from apex_tpu_torch.models.transformer_lm import gpt_loss, mesh_ctx
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.optimizers._common import float_leaves
    from apex_tpu_torch.parallel import create_mesh, shard_batch
    from apex_tpu_torch.utils.collectives import grad_mean

    mesh = create_mesh(dp=inputs["dp"], sp=inputs["sp"])
    cfg = _tiny_cfg(torch.float32, **inputs.get("cfg", {}))
    out = {}
    for mode in ("ring", "ulysses"):
        ctx = mesh_ctx(mesh, seq_axis="sp", context_parallel=mode)
        params = params_from_numpy(inputs["params"], device="cpu")
        leaves = float_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tok, lab = (shard_batch(mesh, shard_batch(
            mesh, torch.as_tensor(inputs[x]).long(), axis="dp"),
            axis="sp", dim=1) for x in ("tokens", "labels"))
        loss = gpt_loss(params, tok, lab, cfg, ctx=ctx)
        grads = torch.autograd.grad(loss, leaves)
        grads = grad_mean(list(grads), ctx.loss_group)
        out[mode] = {"loss": float(loss), "grads": [_np(g) for g in grads]}

        o2 = _tiny_cfg(torch.bfloat16, **inputs.get("cfg", {}))
        _, step = make_gpt_train_step(o2, fused_adam(lr=1e-3), "O2", mesh,
                                      seq_axis="sp", context_parallel=mode,
                                      device="cpu", norm_telemetry=True)
        state = train_state_from_jax(inputs["o2_state"], device="cpu")
        seq = []
        for tok_g, lab_g in inputs["o2_batches"]:
            state, m = step(state, tok_g, lab_g)
            seq.append((float(m["loss"]), bool(m["overflow"]),
                        float(m["grad_norm"])))
        out[mode]["o2"] = seq
        out[mode]["o2_masters"] = [_np(x) for x in
                                   float_leaves(state.master_params)]
    out["dropout"] = _cp_dropout_cases(mesh, inputs)
    return out


def _cp_dropout_cases(mesh, inputs):
    """Hidden dropout and drop-path on the ring (each rank's slice of the
    global masks), and the degraded gathered path: attention dropout (one
    warning a process; ``APEX_TPU_CP_STRICT=1`` raises instead) and a key
    padding mask."""
    import warnings

    from apex_tpu_torch.models.convert import params_from_numpy
    from apex_tpu_torch.models.transformer_lm import gpt_loss, mesh_ctx
    from apex_tpu_torch.optimizers._common import float_leaves
    from apex_tpu_torch.parallel import shard_batch
    from apex_tpu_torch.utils.collectives import grad_mean

    ctx = mesh_ctx(mesh, seq_axis="sp", context_parallel="ring")
    tok, lab = (shard_batch(mesh, shard_batch(
        mesh, torch.as_tensor(inputs[x]).long(), axis="dp"),
        axis="sp", dim=1) for x in ("tokens", "labels"))
    kpm = shard_batch(mesh, torch.as_tensor(inputs["kpm"]), axis="dp")
    words = torch.as_tensor(inputs["words"])
    out = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for name, kw, extra in (
                ("hidden", dict(hidden_dropout=0.1, drop_path_rate=0.1),
                 dict(dropout_rng=words)),
                ("attention", dict(attention_dropout=0.1),
                 dict(dropout_rng=words)),
                ("padding", dict(attn_mask_type="padding"),
                 dict(attention_mask=kpm))):
            cfg = _tiny_cfg(torch.float32, **kw)
            params = params_from_numpy(inputs["params"], device="cpu")
            leaves = float_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss = gpt_loss(params, tok, lab, cfg, ctx=ctx, **extra)
            grads = grad_mean(list(torch.autograd.grad(loss, leaves)),
                             ctx.loss_group)
            out[name] = {"loss": float(loss),
                         "grads": [_np(g) for g in grads]}
    out["warnings"] = sum("DEGRADED" in str(w.message) for w in caught)
    os.environ["APEX_TPU_CP_STRICT"] = "1"
    try:
        gpt_loss(params, tok, lab, cfg, ctx=ctx, attention_mask=kpm)
        out["strict_raised"] = False
    except ValueError as e:
        out["strict_raised"] = "DEGRADED" in str(e)
    finally:
        del os.environ["APEX_TPU_CP_STRICT"]
    return out


def _mlp_loss(params, x, y):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return ((h @ params["w2"] + params["b2"] - y) ** 2).mean()


def job_ddp(rank, inputs):
    """make_ddp_train_step (fp32 wire) and amp.make_train_step(axis_name=,
    grad_comm=) over dp on a tanh MLP, and one compressed all-reduce with
    its residual."""
    from apex_tpu_torch import comm
    from apex_tpu_torch.amp.frontend import make_train_step
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.optimizers._common import float_leaves
    from apex_tpu_torch.parallel import (
        allreduce_gradients, create_mesh, make_ddp_train_step, shard_batch)
    from apex_tpu_torch.transformer import parallel_state

    mesh = create_mesh(dp=inputs["dp"])
    parallel_state.install_mesh(mesh)
    group = mesh.group("dp")
    out = {}
    for wire in ("ddp", "fp32", "bf16", "int8"):
        params = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
        if wire == "ddp":
            init, step = make_ddp_train_step(
                _mlp_loss, fused_adam(lr=1e-3), "O0", mesh, batch_axes=2,
                device="cpu")
        else:
            init, amp_step = make_train_step(
                _mlp_loss, fused_adam(lr=1e-3), "O0", axis_name="dp",
                grad_comm=wire, device="cpu")

            def step(state, x, y, amp_step=amp_step):
                return amp_step(state, shard_batch(mesh, x),
                                shard_batch(mesh, y))
        state = init(params)
        losses = []
        for x, y in inputs["batches"]:
            state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
            losses.append(float(m["loss"]))
        if wire != "ddp":
            # amp's loss is the rank's own; the DDP step's is the mean
            losses = [float(allreduce_gradients(torch.tensor(v), group))
                      for v in losses]
        out[wire] = {"losses": losses,
                     "masters": [_np(x)
                                 for x in float_leaves(state.master_params)],
                     "comm_state": (None if state.comm_state is None else
                                    [_np(r) for r in state.comm_state])}
    flat = torch.as_tensor(inputs["flat"][rank])
    res = torch.as_tensor(inputs["residual"][rank])
    red, err = comm.compressed_allreduce(flat, group,
                                         comm.resolve("int8"), residual=res)
    out["allreduce"] = {"reduced": _np(red), "residual": _np(err)}
    out["plain_mean"] = _np(allreduce_gradients(flat, group))
    shard = -(-flat.shape[0] // inputs["dp"])
    part, err = comm.compressed_reduce_scatter(
        flat, group, comm.resolve("int8"), shard_size=shard, residual=res)
    out["reduce_scatter"] = {"shard": _np(part), "residual": _np(err)}
    out["wrappers"] = _ddp_wrappers(rank, inputs, mesh)
    return out


def _ddp_wrappers(rank, inputs, mesh):
    """DistributedDataParallel's hooked gradients, Reducer.reduce and
    clip_grad_norm over the dp group, on this rank's shard of the first
    batch."""
    from apex_tpu_torch.optimizers._common import float_leaves
    from apex_tpu_torch.parallel import (
        DistributedDataParallel, Reducer, clip_grad_norm, shard_batch)

    x, y = (shard_batch(mesh, torch.from_numpy(a))
            for a in inputs["batches"][0])
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in inputs["params"].items()}
    leaves = float_leaves(params)
    local = torch.autograd.grad(_mlp_loss(params, x, y), leaves)
    hooked = torch.autograd.grad(
        DistributedDataParallel(_mlp_loss)(params, x, y), leaves)
    reduced = Reducer(gradient_predivide_factor=2.0).reduce(list(local))
    # a norm over the group of leaves that each rank holds a part of:
    # rank r's half of every leaf
    halves = [g.reshape(-1).chunk(2)[rank] for g in local]
    _, total = clip_grad_norm(halves, 1.0, group=mesh.group("dp"))
    _, inf_total = clip_grad_norm(halves, 1.0, norm_type=float("inf"),
                                  group=mesh.group("dp"))
    return {"local": [_np(g) for g in local],
            "hooked": [_np(g) for g in hooked],
            "reducer": [_np(g) for g in reduced],
            "group_norm": float(total), "group_inf_norm": float(inf_total)}


def main(argv):
    job, rank, world, port, directory = argv
    rank, world = int(rank), int(world)
    from apex_tpu_torch.parallel import destroy_distributed, init_distributed

    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        inputs = torch.load(Path(directory) / "inputs.pt", weights_only=False)
        result = globals()[f"job_{job}"](rank, inputs)
        torch.save(result, Path(directory) / f"out{rank}.pt")
    finally:
        destroy_distributed()


if __name__ == "__main__":
    np.seterr(all="ignore")
    main(sys.argv[1:])
