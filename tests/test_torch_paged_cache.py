"""The port's paged-cache host and write edges against the JAX package's
on the CPU: int8 quantization and the quantized scatter bit for bit, the
chained prefix digests byte for byte, a random BlockManager op script
leaving identical free lists, refcounts and digests, and the prefill
inserts (native and int8, with dropped pages and padding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.serving import paged_cache as jpc
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.serving import paged_cache as tpc


def _kv(seed, shape, zero_rows=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.uniform(0.01, 5, shape[:-1])[..., None])
    x = x.astype(np.float32)
    if zero_rows:
        x[0, 0] = 0.0                        # an all-zero row: scale 1
        x[-1, -1, :3] = 0.5                  # ties at the rounding edge
    return x


@pytest.mark.parametrize("shape", [(3, 8, 2, 16), (5, 4, 64)])
def test_quantize_kv_bitwise(shape):
    x = _kv(0, shape)
    jw, js = jpc.quantize_kv(jnp.asarray(x))
    tw, ts = tpc.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert bool((ts.view(-1)[0] == 1.0))
    np.testing.assert_array_equal(
        tpc.dequantize_kv(tw, ts).numpy(),
        np.asarray(jpc.dequantize_kv(jw, js)))


def test_quantize_kv_nan_poisons_scale():
    x = _kv(1, (2, 4, 8))
    x[1, 2, 5] = np.nan
    _, ts = tpc.quantize_kv(torch.from_numpy(x))
    _, js = jpc.quantize_kv(jnp.asarray(x))
    assert np.isnan(ts[1, 2].item()) and np.isnan(np.asarray(js)[1, 2])
    assert np.isfinite(ts.numpy()).sum() == ts.numel() - 1


def test_scatter_kv_quantized_bitwise():
    rng = np.random.RandomState(2)
    nb, bs, g, dh = 6, 4, 2, 16
    pools = [np.asarray(rng.randint(-5, 5, (nb, bs, g, dh)), np.int8),
             np.asarray(rng.randint(-5, 5, (nb, bs, g, dh)), np.int8),
             rng.rand(nb, bs, g).astype(np.float32),
             rng.rand(nb, bs, g).astype(np.float32)]
    k, v = _kv(3, (5, g, dh)), _kv(4, (5, g, dh))
    blk = np.asarray([0, 3, 3, 5, 1])
    off = np.asarray([1, 0, 3, 2, 2])
    want = jpc.scatter_kv_quantized(
        *map(jnp.asarray, pools), jnp.asarray(k), jnp.asarray(v),
        (jnp.asarray(blk), jnp.asarray(off)))
    got = [torch.from_numpy(p.copy()) for p in pools]
    tpc.scatter_kv_quantized(*got, torch.from_numpy(k), torch.from_numpy(v),
                             (torch.from_numpy(blk), torch.from_numpy(off)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("dropped", ["none", "some", "first", "all"])
def test_write_cells_drops_like_jax(dropped, layered):
    """A planned write with dropped cells (sentinel blocks past the pool)
    against the JAX ``.at[].set(mode="drop")``: kept cells take their own
    values, every other cell keeps what it held (nothing kept included),
    for every pool of the write through one plan."""
    rng = np.random.RandomState(5)
    L, nb, bs, g, dh, n = 2, 6, 4, 2, 8, 5
    lead = (L,) if layered else ()
    pools = [rng.randn(*lead, nb, bs, g, dh).astype(np.float32),
             rng.randn(*lead, nb, bs, g).astype(np.float32)]
    vals = [rng.randn(*lead, n, g, dh).astype(np.float32),
            rng.randn(*lead, n, g).astype(np.float32)]
    blk = np.asarray([4, 0, 3, 5, 1])
    off = np.asarray([1, 2, 3, 0, 2])
    drop = {"none": [], "some": [1, 3], "first": [0, 2],
            "all": list(range(n))}[dropped]
    blk[drop] = nb                            # the unmapped sentinel
    jidx = (slice(None),) * len(lead) + (jnp.asarray(blk),
                                         jnp.asarray(off))
    want = [jnp.asarray(p).at[jidx].set(jnp.asarray(v), mode="drop")
            for p, v in zip(pools, vals)]
    got = [torch.from_numpy(p.copy()) for p in pools]
    tb = torch.from_numpy(blk)
    cells = tpc.plan_cells((slice(None),) * len(lead)
                           + (tb, torch.from_numpy(off)), tb < nb)
    tpc.write_cells(got, [torch.from_numpy(v) for v in vals], cells)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("salt", [b"", b"chunk:8"])
def test_prefix_block_hashes_byte_equal(salt):
    tokens = np.random.RandomState(5).randint(0, 50304, (70,))
    for bs in (1, 4, 16):
        assert tpc.prefix_block_hashes(tokens, bs, salt=salt) == \
            jpc.prefix_block_hashes(tokens, bs, salt=salt)
    assert tpc.chunk_salt(8) == jpc.chunk_salt(8)


def _ledger(m):
    return (list(m._free), dict(m._ref), dict(m._hash_to_block),
            dict(m._block_to_hash), list(m._pub_order), m.n_free,
            m.n_in_use, m.n_shared, m.newest_digests(5))


def test_block_manager_random_script_identical():
    rng = np.random.RandomState(6)
    jm, tm = jpc.BlockManager(12, 4), tpc.BlockManager(12, 4)
    owned = []
    digests = jpc.prefix_block_hashes(rng.randint(0, 100, (40,)), 4)
    for _ in range(400):
        op = rng.randint(0, 6)
        if op == 0:
            a, b = jm.alloc(), tm.alloc()
            assert a == b
            if a is not None:
                owned.append(a)
        elif op == 1 and owned:
            blk = owned.pop(rng.randint(len(owned)))
            assert jm.decref(blk) == tm.decref(blk)
        elif op == 2 and owned:
            blk = owned[rng.randint(len(owned))]
            h = digests[rng.randint(len(digests))]
            jm.publish_prefix(h, blk)
            tm.publish_prefix(h, blk)
        elif op == 3:
            h = digests[rng.randint(len(digests))]
            a, b = jm.share_prefix(h), tm.share_prefix(h)
            assert a == b
            if a is not None:
                owned.append(a)
        elif op == 4 and owned:
            i = rng.randint(len(owned))
            a, b = jm.ensure_private(owned[i]), tm.ensure_private(owned[i])
            assert a == b
            if a[1] and a[0] is not None:
                owned[i] = a[0]
        elif op == 5 and owned:
            blk = owned[rng.randint(len(owned))]
            assert jm.digest_of(blk) == tm.digest_of(blk)
            assert jm.refcount(blk) == tm.refcount(blk)
        assert _ledger(jm) == _ledger(tm)
    jm.free_all(owned)
    tm.free_all(owned)
    assert _ledger(jm) == _ledger(tm) and tm.n_in_use == 0


def _cfgs():
    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
              num_query_groups=2)
    return (JConfig(compute_dtype=jnp.float32, **kw),
            TConfig(compute_dtype=torch.float32, **kw))


@pytest.mark.parametrize("wire", ["native", "int8"])
def test_paged_insert_prefill_matches_jax(wire):
    jcfg, tcfg = _cfgs()
    nb, bs, S = 7, 4, 16
    jpool = jpc.init_paged_pool(jcfg, nb, bs, cache_wire=wire)
    tpool = tpc.init_paged_pool(tcfg, nb, bs, cache_wire=wire, device="cpu")
    assert sorted(jpool) == sorted(tpool)
    ks, vs = _kv(7, (2, 1, S, 2, 16), False), _kv(8, (2, 1, S, 2, 16), False)
    # page 1 is shared (sentinel: dropped), the padding page drops too
    wid = np.asarray([4, nb, 2, nb], np.int32)
    n = 11
    if wire == "int8":
        want = jpc.paged_insert_prefill_q(
            jpool["k"], jpool["v"], jpool["k_scale"], jpool["v_scale"],
            jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(wid),
            jnp.int32(n), block_size=bs)
        tpc.paged_insert_prefill_q(
            tpool["k"], tpool["v"], tpool["k_scale"], tpool["v_scale"],
            torch.from_numpy(ks), torch.from_numpy(vs), wid, n,
            block_size=bs)
        got = [tpool[k] for k in ("k", "v", "k_scale", "v_scale")]
    else:
        want = jpc.paged_insert_prefill(
            jpool["k"], jpool["v"], jnp.asarray(ks), jnp.asarray(vs),
            jnp.asarray(wid), jnp.int32(n), block_size=bs)
        tpc.paged_insert_prefill(tpool["k"], tpool["v"],
                                 torch.from_numpy(ks), torch.from_numpy(vs),
                                 wid, n, block_size=bs)
        got = [tpool["k"], tpool["v"]]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ids = [4, 2]
    for a, b in zip(tpc.gather_block_kv(tpool["k"], tpool["v"], ids),
                    jpc.gather_block_kv(jnp.asarray(got[0].numpy()),
                                        jnp.asarray(got[1].numpy()), ids)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if wire == "int8":
        np.testing.assert_array_equal(
            tpc.gather_block_scales(tpool["k_scale"], ids).numpy(),
            np.asarray(jpc.gather_block_scales(jnp.asarray(
                got[2].numpy()), ids)))


def test_resolve_cache_wire_and_blocks_for():
    for w in (None, "native", "int8"):
        assert tpc.resolve_cache_wire(w) == jpc.resolve_cache_wire(w)
    with pytest.raises(ValueError, match="cache_wire"):
        tpc.resolve_cache_wire("fp8")
    for n in (0, 1, 15, 16, 17):
        assert tpc.blocks_for(n, 16) == jpc.blocks_for(n, 16)
