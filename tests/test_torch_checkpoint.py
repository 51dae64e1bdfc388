"""The port's train-state checkpoint (``apex_tpu_torch/checkpoint``,
``utils/checkpoint.py``, the ``amp`` hooks) on the CPU: the
single-process cases of tests/test_train_checkpoint.py, and checkpoints
crossing between the two packages.

Round trips are bitwise: a run restored from a snapshot repeats the
unkilled run's losses, masters, moments and scaler bits exactly (the
scaler's mid-doubling window included).  Torn and corrupt manifests are
invisible, digests catch a flipped byte, retention, validation, the extra
payload and a recommitted step behave as in JAX; the async saver is
durable after ``wait``, its snapshot is safe against the next step
writing the same tensors in place, and a background failure surfaces on
the next call; recovery rolls back on a non-finite loss, re-warms the
learning rate and gives up after ``max_rollbacks``.

Across packages: a checkpoint ``apex_tpu.checkpoint.save_sharded`` writes
of a tiny GPT O2 train state restores in the port's ``restore_sharded``
into a fresh port state, bit for bit, and both packages then step on in
lockstep (losses within 3e-2 and identical scaler decisions,
tests/torch_train_cases.py's O2 bounds); the port's manifest of the same
state has JAX's leaf keys, shapes, dtypes and digests, and JAX restores
the port's files bit for bit."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.scaler import LossScaleState as JLossScaleState
from apex_tpu.checkpoint import load_manifest as j_load_manifest
from apex_tpu.checkpoint import restore_sharded as j_restore
from apex_tpu.checkpoint import save_sharded as j_save
from apex_tpu.models.config import gpt_tiny as j_tiny
from apex_tpu.models.gpt import make_gpt_train_step as j_make
from apex_tpu.optimizers import fused_adam as j_adam
from apex_tpu_torch import amp
from apex_tpu_torch.amp import scaler as scaler_lib
from apex_tpu_torch.amp.frontend import AmpState, make_train_step
from apex_tpu_torch.amp.policy import policy_for_opt_level
from apex_tpu_torch.checkpoint import (
    AsyncCheckpointer, CheckpointError, RecoveryGivingUp, RecoveryManager,
    RollbackConfig, all_steps, latest_step, load_manifest, restore_sharded,
    save_sharded)
from apex_tpu_torch.models.config import gpt_tiny as t_tiny
from apex_tpu_torch.models.convert import train_state_from_jax
from apex_tpu_torch.models.gpt import make_gpt_train_step as t_make
from apex_tpu_torch.observability import metrics as telemetry
from apex_tpu_torch.optimizers import fused_adam, fused_lamb
from apex_tpu_torch.utils import checkpoint as ucheck

LOSS_TOL = 3e-2


def _mlp_params(seed=7):
    r = np.random.RandomState(seed)
    return {"w1": torch.from_numpy(r.randn(8, 16) * 0.3).float(),
            "b1": torch.zeros(16),
            "w2": torch.from_numpy(r.randn(16, 4) * 0.3).float()}


def _mlp_loss(p, x, y):
    h = torch.tanh(x @ p["w1"].to(x.dtype) + p["b1"].to(x.dtype))
    return torch.mean((h @ p["w2"].to(x.dtype) - y) ** 2)


def _batch(i, b=16):
    r = np.random.RandomState(50_000 + i)
    return (torch.from_numpy(r.randn(b, 8)).float(),
            torch.from_numpy(r.randn(b, 4)).float())


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for x in tree for v in _leaves(x)]
    return [tree] if torch.is_tensor(tree) else []


def _bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.reshape(-1).view(torch.uint8).equal(
            y.reshape(-1).view(torch.uint8))


class TestTrainStateRoundTrip:
    @pytest.mark.parametrize("opt", ["adam", "lamb"])
    def test_bitwise_trajectory(self, tmp_path, opt):
        tx = fused_adam(lr=1e-2) if opt == "adam" else fused_lamb(lr=1e-2)
        init, step = make_train_step(_mlp_loss, tx, "O2", device="cpu")
        state = init(_mlp_params())
        traj = []
        for i in range(1, 7):
            state, m = step(state, *_batch(i))
            traj.append(m["loss"])
            if i == 3:
                amp.save_train_state(str(tmp_path), 3, state)
        final = state
        resumed = amp.restore_train_state(str(tmp_path),
                                          init(_mlp_params(seed=1)))
        for i in range(4, 7):
            resumed, m = step(resumed, *_batch(i))
            assert torch.equal(m["loss"], traj[i - 1]), i
        _bitwise(resumed, final)

    def test_scaler_mid_doubling_window(self, tmp_path):
        cfg, st0 = scaler_lib.init_loss_scale("dynamic", scale_window=4,
                                              device="cpu")
        amp_state = AmpState(policy_for_opt_level("O2"), cfg, st0)
        init, step = make_train_step(_mlp_loss, fused_adam(lr=1e-2),
                                     amp_state, device="cpu")
        state = init(_mlp_params())
        scales = []
        for i in range(1, 7):
            state, _ = step(state, *_batch(i))
            scales.append(state.loss_scale_state.loss_scale.clone())
            if i == 3:
                assert int(state.loss_scale_state.unskipped) == 3
                save_sharded(str(tmp_path), 3, state)
        resumed = restore_sharded(str(tmp_path), init(_mlp_params()))
        assert int(resumed.loss_scale_state.unskipped) == 3
        for i in range(4, 7):
            resumed, _ = step(resumed, *_batch(i))
            assert torch.equal(resumed.loss_scale_state.loss_scale,
                               scales[i - 1]), i

    def test_frontend_scaler_hooks(self):
        init, step = make_train_step(_mlp_loss, fused_adam(lr=1e-2), "O2",
                                     device="cpu")
        state, _ = step(init(_mlp_params()), *_batch(1))
        d = amp.state_dict(state)
        assert d == {"loss_scaler0": {
            "loss_scale": float(state.loss_scale_state.loss_scale),
            "unskipped": int(state.loss_scale_state.unskipped)}}
        ls = amp.load_state_dict(json.loads(json.dumps(d)), device="cpu")
        assert torch.equal(ls.loss_scale, state.loss_scale_state.loss_scale)
        assert ls.unskipped.dtype == torch.int32

    def test_mixed_leaves(self, tmp_path):
        state = {"f": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
                 "i": torch.tensor(3, dtype=torch.int32),
                 "n": np.arange(4, dtype=np.int64), "s": 2.5,
                 "t": (torch.ones(2, dtype=torch.float16), None)}
        save_sharded(str(tmp_path), 1, state)
        like = {"f": torch.zeros(2, 3, dtype=torch.bfloat16),
                "i": torch.tensor(0, dtype=torch.int32),
                "n": np.zeros(4, np.int64), "s": 0.0,
                "t": (torch.zeros(2, dtype=torch.float16), None)}
        r = restore_sharded(str(tmp_path), like)
        assert torch.equal(r["f"], state["f"]) and r["i"] == 3
        assert np.array_equal(r["n"], state["n"]) and r["s"] == 2.5
        assert isinstance(r["s"], float) and r["t"][1] is None
        assert list(r) == list(like)


class TestManifest:
    def test_torn_snapshot_is_invisible(self, tmp_path):
        state = {"a": torch.arange(4.0)}
        save_sharded(str(tmp_path), 1, state)
        save_sharded(str(tmp_path), 2, state)
        os.remove(tmp_path / "step_00000002" / "MANIFEST.json")
        assert all_steps(str(tmp_path)) == [1]
        assert latest_step(str(tmp_path)) == 1
        r = restore_sharded(str(tmp_path), {"a": torch.zeros(4)})
        assert torch.equal(r["a"], state["a"])

    def test_corrupt_manifest_is_invisible(self, tmp_path):
        save_sharded(str(tmp_path), 1, {"a": torch.arange(4.0)})
        save_sharded(str(tmp_path), 2, {"a": torch.arange(4.0)})
        with open(tmp_path / "step_00000002" / "MANIFEST.json", "w") as f:
            f.write('{"manifest_schema_version": 1, "truncated')
        assert all_steps(str(tmp_path)) == [1]

    def test_digest_detects_corruption(self, tmp_path):
        save_sharded(str(tmp_path), 1, {"a": torch.arange(64.0)})
        shard = tmp_path / "step_00000001" / "shard_p0.bin"
        raw = bytearray(shard.read_bytes())
        raw[7] ^= 0xFF
        shard.write_bytes(bytes(raw))
        with pytest.raises(CheckpointError, match="digest"):
            restore_sharded(str(tmp_path), {"a": torch.zeros(64)})
        restore_sharded(str(tmp_path), {"a": torch.zeros(64)},
                        verify_digests=False)

    def test_retention_policy(self, tmp_path):
        state = {"a": torch.arange(8.0)}
        for s in (1, 2, 3, 4):
            save_sharded(str(tmp_path), s, state, keep=2)
        assert all_steps(str(tmp_path)) == [3, 4]
        torn = tmp_path / "step_00000002"
        torn.mkdir()
        (torn / "shard_p0.bin").write_bytes(b"junk")
        save_sharded(str(tmp_path), 5, state, keep=2)
        assert all_steps(str(tmp_path)) == [4, 5]
        assert not torn.exists()

    def test_structure_shape_dtype_validation(self, tmp_path):
        save_sharded(str(tmp_path), 1, {
            "a": torch.zeros(4, 4), "b": torch.zeros(3, dtype=torch.int32)})
        with pytest.raises(CheckpointError, match="structure"):
            restore_sharded(str(tmp_path), {"a": torch.zeros(4, 4)})
        with pytest.raises(CheckpointError, match="shape"):
            restore_sharded(str(tmp_path), {
                "a": torch.zeros(4, 2), "b": torch.zeros(3,
                                                         dtype=torch.int32)})
        with pytest.raises(CheckpointError, match="dtype"):
            restore_sharded(str(tmp_path), {"a": torch.zeros(4, 4),
                                            "b": torch.zeros(3)})

    def test_extra_payload(self, tmp_path):
        save_sharded(str(tmp_path), 7, {"a": torch.zeros(2)},
                     extra={"data_position": 1234})
        assert load_manifest(str(tmp_path))["extra"]["data_position"] == 1234

    def test_recommit_same_step(self, tmp_path):
        save_sharded(str(tmp_path), 1, {"a": torch.zeros(4)})
        save_sharded(str(tmp_path), 1, {"a": torch.ones(4)})
        r = restore_sharded(str(tmp_path), {"a": torch.zeros(4)})
        assert torch.equal(r["a"], torch.ones(4))
        assert not (tmp_path / "step_00000001" / "MANIFEST.p0.json").exists()

    def test_distributed_forms_raise(self, tmp_path):
        save_sharded(str(tmp_path), 1, {"a": torch.zeros(4)})
        with pytest.raises(NotImplementedError,
                           match="distributed-training slice"):
            restore_sharded(str(tmp_path), {"a": torch.zeros(4)},
                            reshard=True)
        with pytest.raises(NotImplementedError,
                           match="distributed-training slice"):
            save_sharded(str(tmp_path), 2, {"a": torch.zeros(4)},
                         process_index=1, expected_processes=2)
        with pytest.raises(NotImplementedError,
                           match="distributed-training slice"):
            amp.restore_train_state(str(tmp_path), {"a": torch.zeros(4)},
                                    reshard=True)


class TestAsyncSaver:
    def test_durable_after_wait_and_bounded_in_flight(self, tmp_path):
        state = {"a": torch.arange(1024.0)}
        with AsyncCheckpointer(str(tmp_path), keep=2) as ck:
            ck.save(1, state)
            ck.save(2, state)      # waits out save 1 first
            res = ck.wait()
        assert res.step == 2 and res.bytes == 4096
        assert 0.0 <= res.overlap_ratio <= 1.0
        assert all_steps(str(tmp_path)) == [1, 2]

    def test_snapshot_safety(self, tmp_path):
        """The next step writing the same tensors in place right after
        save() returns must not reach the checkpoint."""
        state = {"a": torch.arange(4096.0)}
        expect = state["a"].clone()
        with AsyncCheckpointer(str(tmp_path)) as ck:
            ck.save(1, state)
            state["a"].mul_(2)
        r = restore_sharded(str(tmp_path), {"a": torch.zeros(4096)})
        assert torch.equal(r["a"], expect)

    def test_background_failure_surfaces_on_next_call(self, tmp_path):
        target = tmp_path / "not_a_dir"
        target.write_text("occupied")
        ck = AsyncCheckpointer(str(target))
        ck.save(1, {"a": torch.zeros(4)})
        with pytest.raises(CheckpointError, match="background"):
            ck.wait()
        ck.close()

    def test_save_telemetry(self, tmp_path):
        reg = telemetry.configure()
        try:
            with AsyncCheckpointer(str(tmp_path)) as ck:
                ck.save(1, {"a": torch.arange(256.0)})
            assert reg.counter("checkpoint.saves").value == 1
            assert reg.counter("checkpoint.bytes").value == 1024
            assert reg.gauge("checkpoint.overlap_ratio").value is not None
            assert reg.histogram("checkpoint.save").count == 1
            assert reg.histogram("checkpoint.blocking").count == 1
            assert any(e["name"] == "checkpoint.committed"
                       for e in reg.events)
            restore_sharded(str(tmp_path), {"a": torch.zeros(256)})
            assert reg.counter("checkpoint.restores").value == 1
        finally:
            telemetry.shutdown()


def _recovery_loop(tmp_path, nan_at=(7,), steps=10, config=None):
    init, step = make_train_step(_mlp_loss, fused_adam(lr=1e-2), "O2",
                                 device="cpu")
    kw = {"config": config} if config is not None else {}
    mgr = RecoveryManager(str(tmp_path), save_every=2, keep=3, **kw)
    state = init(_mlp_params())
    rolled, m = [], None
    for i in range(1, steps + 1):
        x, y = _batch(i)
        if i in nan_at:
            x = x * float("nan")
        state, m = step(state, x, y)
        state, r = mgr.after_step(state, m)
        if r:
            rolled.append(i)
    mgr.saver.close()
    return mgr, state, m, rolled


class TestRecovery:
    def test_nan_triggers_rollback_rewarm_and_incident(self, tmp_path):
        reg = telemetry.configure()
        try:
            mgr, state, m, rolled = _recovery_loop(tmp_path / "ck")
            assert rolled == [7]
            assert mgr.last_rollback_step == 6
            assert int(state.step) == 9       # 6, then steps 8-10 clean
            assert reg.counter("checkpoint.rollbacks").value == 1
            assert any(e["name"] == "anomaly.rollback" for e in reg.events)
            assert 0.1 <= mgr.lr_scale() < 1.0
            sched = mgr.rewarm_schedule(1e-3)
            anchor = mgr.last_rollback_step
            assert float(sched(anchor)) == pytest.approx(1e-4)
            assert float(sched(torch.tensor(anchor + 100))) == \
                pytest.approx(1e-3)
        finally:
            telemetry.shutdown()

    def test_recovery_without_telemetry(self, tmp_path):
        assert telemetry.registry() is None
        mgr, state, m, rolled = _recovery_loop(tmp_path)
        assert rolled == [7]
        assert np.isfinite(float(m["loss"]))

    def test_gives_up_after_max_rollbacks(self, tmp_path):
        with pytest.raises(RecoveryGivingUp):
            _recovery_loop(tmp_path, nan_at=(5, 6, 7, 8), steps=10,
                           config=RollbackConfig(max_rollbacks=2))

    def test_no_checkpoint_to_roll_back_to(self, tmp_path):
        with pytest.raises(CheckpointError, match="no committed"):
            _recovery_loop(tmp_path, nan_at=(1,), steps=2)

    def test_anomaly_events_trigger_and_earlier_ones_do_not(self, tmp_path):
        reg = telemetry.configure()
        try:
            telemetry.event("anomaly.loss_spike", step=0)   # history
            init, step = make_train_step(_mlp_loss, fused_adam(lr=1e-2),
                                         "O2", device="cpu")
            mgr = RecoveryManager(str(tmp_path), save_every=1)
            state = init(_mlp_params())
            state, m = step(state, *_batch(1))
            state, rolled = mgr.after_step(state, m)
            assert not rolled
            mgr.saver.wait()
            telemetry.event("anomaly.scaler_thrash", step=1)  # not a trigger
            state, m = step(state, *_batch(2))
            state, rolled = mgr.after_step(state, m)
            assert not rolled
            mgr.saver.wait()
            state, m = step(state, *_batch(3))
            telemetry.event("anomaly.grad_norm_explosion", step=3)
            state, rolled = mgr.after_step(state, m)
            assert rolled and mgr.last_rollback_step == 2
            assert reg.counter("checkpoint.rollbacks").value == 1
            mgr.saver.close()
        finally:
            telemetry.shutdown()

    def test_no_resave_while_counter_stalls(self, tmp_path):
        class _Stuck:
            step = torch.tensor(4, dtype=torch.int32)

        saves = []

        class _Saver:
            def save(self, step, state, extra=None):
                saves.append(step)

            def wait(self):
                return None

            def close(self):
                return None

        mgr = RecoveryManager(str(tmp_path), save_every=4, saver=_Saver())
        for _ in range(5):
            mgr.after_step(_Stuck(), {"loss": 1.0})
        assert saves == [4]

    def test_second_divergence_after_recovery_is_detected(self, tmp_path):
        mgr, state, m, rolled = _recovery_loop(tmp_path, nan_at=(5, 9),
                                               steps=12)
        assert rolled == [5, 9]
        assert mgr.rollbacks == 2


class TestUtilsCheckpoint:
    def test_save_restore_latest_and_async(self, tmp_path):
        state = {"w": torch.arange(6.0).reshape(2, 3),
                 "step": torch.tensor(5, dtype=torch.int32)}
        path = ucheck.save_checkpoint(str(tmp_path), 5, state)
        assert path.endswith("step_00000005")
        assert os.path.exists(os.path.join(path, "MANIFEST.json"))
        assert ucheck.latest_step(str(tmp_path)) == 5
        r = ucheck.restore_checkpoint(str(tmp_path), {
            "w": torch.zeros(2, 3), "step": torch.tensor(0,
                                                         dtype=torch.int32)})
        _bitwise(r, state)
        with ucheck.async_saver() as saver:
            saver.save(str(tmp_path), 6, state)
            saver.save(str(tmp_path), 7, state)
        assert all_steps(str(tmp_path)) == [5, 6, 7]
        with pytest.raises(FileNotFoundError):
            ucheck.restore_checkpoint(str(tmp_path / "empty"), state)

    def test_auto_resume(self, tmp_path):
        f = tmp_path / "term"
        ar = ucheck.AutoResume(str(f)).init()
        assert not ar.termination_requested()
        f.write_text("")
        assert ar.termination_requested()
        ar.request_resume()
        assert not f.exists()


GEOM = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=256, max_position_embeddings=32, fused_head_ce=True,
            head_ce_chunk=24)


def _jax_gpt(steps):
    jcfg = j_tiny(compute_dtype=jnp.bfloat16, scan_layers=False, **GEOM)
    j_init, j_step = j_make(jcfg, j_adam(lr=1e-3), "O2")
    js = j_init(jax.random.PRNGKey(0))
    js = js._replace(loss_scale_state=JLossScaleState(
        jnp.float32(2.0 ** 15), jnp.int32(0)))
    rng = np.random.RandomState(11)
    batches = [(rng.randint(0, 256, (2, 32)).astype(np.int32),
                rng.randint(0, 256, (2, 32)).astype(np.int32))
               for _ in range(steps + 3)]
    for tok, lab in batches[:steps]:
        js, _ = j_step(js, jnp.asarray(tok), jnp.asarray(lab))
    return j_step, js, batches[steps:]


def test_jax_checkpoint_restores_in_the_port_and_continues(tmp_path):
    j_step, js, rest = _jax_gpt(2)
    j_save(str(tmp_path), 2, js)
    tcfg = t_tiny(compute_dtype=torch.bfloat16, **GEOM)
    t_init, t_step = t_make(tcfg, fused_adam(lr=1e-3), "O2", device="cpu")
    ts = amp.restore_train_state(
        str(tmp_path), t_init(torch.Generator().manual_seed(9)))
    want = train_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    _bitwise(ts, want)
    for tok, lab in rest:
        js, jm = j_step(js, jnp.asarray(tok), jnp.asarray(lab))
        ts, tm = t_step(ts, torch.from_numpy(tok), torch.from_numpy(lab))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
        assert (bool(tm["overflow"]), float(tm["loss_scale"])) == \
            (bool(jm["overflow"]), float(jm["loss_scale"]))


def test_port_manifest_matches_jax_and_jax_restores_it(tmp_path):
    _, js, _ = _jax_gpt(1)
    ts = train_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    j_save(str(tmp_path / "jax"), 1, js)
    amp.save_train_state(str(tmp_path / "port"), 1, ts)

    def view(m):
        return [(leaf["key"], leaf["shape"], leaf["dtype"],
                 [s["digest"] for s in leaf["shards"]])
                for leaf in m["leaves"]]

    jm = j_load_manifest(str(tmp_path / "jax"))
    tm = load_manifest(str(tmp_path / "port"))
    assert view(tm) == view(jm)
    assert tm["total_bytes"] == jm["total_bytes"]
    back = j_restore(str(tmp_path / "port"), js)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(js)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
