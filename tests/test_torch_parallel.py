"""The port's mesh collectives and distributed group-by against the JAX
package's, and the plain versions of M1 and M2 against the JAX functions
they replace (CPU; the CUDA kernels are held to the plain versions in
``tests/test_torch_cuda.py`` on the card).

- M1 ``partition_pack`` + ``all_to_all`` (``parallel.exchange.
  partition_exchange``) against JAX ``partition_exchange`` run inside
  ``jax.shard_map`` over the 8 virtual CPU devices, as
  ``tests/test_parallel.py`` runs it: received buckets, received live
  mask and overflow equal bit for bit.
- M2 ``segment_reduce`` against ``kernels.seg_sum``/``seg_min``/
  ``seg_max``: int64 exact, float64 sums to relative 1e-12, float64
  min/max exact (NaN, -0.0, empty segments and dropped ids included).
- ``distributed_group_sums`` against its JAX twin (``test_parallel.py``'s
  two cases), the q1_step twin against ``__graft_entry__.entry()``'s.
- The unsigned destination ``umod`` against numpy's ``uint64 %``.
"""

import collections
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from trino_tpu.exec import kernels as JK
from trino_tpu.parallel.core import WORKER_AXIS, make_mesh as jax_make_mesh
from trino_tpu.parallel.exchange import partition_exchange as jax_partition_exchange
from trino_tpu.parallel.groupby import distributed_group_sums as jax_group_sums
from trino_tpu_torch.exec import kernels as K
from trino_tpu_torch.parallel import make_mesh
from trino_tpu_torch.parallel.exchange import partition_exchange
from trino_tpu_torch.parallel.groupby import distributed_group_sums, q1_step

N_SHARDS = 8

# The JAX package's scan cache registers connector finalizers while it
# holds a non-reentrant lock (ROADMAP Queue 3, item 4), so a garbage
# collection that lands inside it deadlocks the worker. Where collections
# land follows each test worker's allocation history from its start; one
# full collection while the test modules are imported gives every worker
# the same fresh starting point. A stopgap until the reference is fixed:
# remove it then, and do not copy it into other test modules.
gc.collect()


@pytest.fixture(scope="module", autouse=True)
def _collect_at_module_end():
    """Collect this module's runners (their tables, programs and
    connectors, held in reference cycles) when the module ends, so their
    finalizers run here and not inside a later module's allocations."""
    yield
    gc.collect()


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < N_SHARDS:
        pytest.skip("needs 8 JAX devices")
    return jax_make_mesh(N_SHARDS)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_SHARDS, device="cpu")


def _jax_exchange(jax_mesh, dest, live, payload, bucket):
    names = sorted(payload)

    def step(d, lv, *cols):
        recv, rlive, ovf = jax_partition_exchange(
            d, lv, dict(zip(names, cols)), N_SHARDS, bucket, WORKER_AXIS)
        ovf = jax.lax.pmax(ovf.astype(jnp.int32), WORKER_AXIS)
        return [recv[k] for k in names], rlive, ovf

    f = jax.jit(jax.shard_map(
        step, mesh=jax_mesh,
        in_specs=(PS(WORKER_AXIS),) * (2 + len(names)),
        out_specs=([PS(WORKER_AXIS)] * len(names), PS(WORKER_AXIS), PS()),
        check_vma=False,
    ))
    recv, rlive, ovf = f(jnp.asarray(dest), jnp.asarray(live),
                         *[jnp.asarray(payload[k]) for k in names])
    return (
        {k: np.asarray(r) for k, r in zip(names, recv)},
        np.asarray(rlive), bool(int(ovf)),
    )


def _torch_exchange(mesh, dest, live, payload, bucket):
    names = sorted(payload)
    per = len(dest) // N_SHARDS

    def split(a):
        return [torch.from_numpy(np.ascontiguousarray(a[s * per:(s + 1) * per]))
                for s in range(N_SHARDS)]

    cols = [split(payload[k]) for k in names]
    recv, rlive, ovf, counts = partition_exchange(
        split(dest), split(live), [[c[s] for c in cols] for s in range(N_SHARDS)],
        N_SHARDS, bucket, list(mesh.devices))
    got = {
        k: np.concatenate([recv[s][i].numpy() for s in range(N_SHARDS)])
        for i, k in enumerate(names)
    }
    return got, np.concatenate([r.numpy() for r in rlive]), ovf, counts


def _exchange_case(kind, rng):
    per = 64
    n = per * N_SHARDS
    dest = rng.integers(0, N_SHARDS, n).astype(np.int32)
    live = rng.random(n) > 0.2
    payload = {
        "v": rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64),
        "f": rng.standard_normal(n),
        "c": rng.integers(0, 1000, n).astype(np.int32),
        "b": rng.random(n) > 0.5,
        "i8": rng.integers(-100, 100, n).astype(np.int8),
    }
    bucket = 2 * per // N_SHARDS * 2  # 2x mean occupancy
    if kind == "overflow":
        bucket = 4  # every destination overflows; rows drop
    elif kind == "all_dead":
        live[:] = False
    elif kind == "limbs":
        payload["limbs"] = rng.integers(-(1 << 40), 1 << 40, (n, 2)).astype(np.int64)
    elif kind == "one_dest":
        dest[:] = 3
        bucket = per  # one destination holds every live row of a shard
    return dest, live, payload, bucket


@pytest.mark.parametrize(
    "kind", ["no_overflow", "overflow", "all_dead", "limbs", "one_dest"])
def test_partition_exchange_matches_jax(kind, jax_mesh, mesh):
    dest, live, payload, bucket = _exchange_case(kind, np.random.default_rng(3))
    want, want_live, want_ovf = _jax_exchange(jax_mesh, dest, live, payload, bucket)
    got, got_live, got_ovf, counts = _torch_exchange(mesh, dest, live, payload, bucket)
    assert got_ovf == want_ovf
    assert got_ovf == (kind == "overflow")
    np.testing.assert_array_equal(got_live, want_live)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    # the counts are every live row per (shard, destination)
    per = len(dest) // N_SHARDS
    for s in range(N_SHARDS):
        sl = slice(s * per, (s + 1) * per)
        want_counts = np.bincount(dest[sl][live[sl]], minlength=N_SHARDS)
        np.testing.assert_array_equal(counts[s], want_counts)


@pytest.mark.parametrize("kind", ["no_overflow", "overflow", "all_dead", "limbs"])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_partition_pack_dest_dtype_matches_jax(dtype, kind, jax_mesh, mesh):
    """M1 with int32 and int64 destinations, each passed to the port as it
    is (the mesh's destinations are int64 residues of a hash), against
    JAX ``partition_exchange`` given the same array."""
    dest, live, payload, bucket = _exchange_case(kind, np.random.default_rng(5))
    dest = dest.astype(dtype)
    want, want_live, want_ovf = _jax_exchange(jax_mesh, dest, live, payload, bucket)
    got, got_live, got_ovf, counts = _torch_exchange(mesh, dest, live, payload, bucket)
    assert got_ovf == want_ovf == (kind == "overflow")
    np.testing.assert_array_equal(got_live, want_live)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    per = len(dest) // N_SHARDS
    for s in range(N_SHARDS):
        sl = slice(s * per, (s + 1) * per)
        np.testing.assert_array_equal(
            counts[s], np.bincount(dest[sl][live[sl]], minlength=N_SHARDS))


def test_partition_pack_is_stable_and_drops_out_of_range():
    dest = torch.tensor([2, 0, 2, 7, -1, 2, 0], dtype=torch.int64)
    live = torch.tensor([True, True, True, True, True, False, True])
    vals = torch.arange(7, dtype=torch.int64) * 10
    (b,), sent, counts = K.partition_pack(dest, live, [vals], 3, 2)
    assert counts.tolist() == [2, 0, 2]
    assert b.tolist() == [10, 60, 0, 0, 0, 20]
    assert sent.tolist() == [True, True, False, False, True, True]


SEG_OPS = {"sum": JK.seg_sum, "min": JK.seg_min, "max": JK.seg_max}


def _segment_case(dtype, rng, n=5000, n_seg=97):
    group = rng.integers(-3, n_seg + 3, n)  # out-of-range ids drop
    group[(group >= 40) & (group < 45)] = 50  # segments 40-44 stay empty
    if dtype == "int64":
        vals = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
    else:
        vals = rng.standard_normal(n) * 1e6
        vals[rng.random(n) < 0.01] = np.nan
        vals[rng.random(n) < 0.05] = -0.0
        vals[rng.random(n) < 0.05] = 0.0
        # ties between -0.0 and +0.0 alone in a segment
        vals[group == 60] = -0.0
        vals[np.flatnonzero(group == 60)[::2]] = 0.0
    return vals, group, n_seg


@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("ids", ["int32", "int64"])
def test_segment_reduce_matches_jax(op, dtype, ids):
    vals, group, n_seg = _segment_case(dtype, np.random.default_rng(11))
    group = group.astype(ids)
    want = np.asarray(SEG_OPS[op](jnp.asarray(vals), jnp.asarray(group), n_seg))
    got = K.segment_reduce(torch.from_numpy(vals), torch.from_numpy(group),
                           n_seg, op).numpy()
    assert got.dtype == want.dtype
    if dtype == "float64" and op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        assert (np.isnan(got) == np.isnan(want)).all()
        return
    if dtype == "float64":
        assert (np.isnan(got) == np.isnan(want)).all()
        ok = ~np.isnan(want)
        np.testing.assert_array_equal(got[ok], want[ok])
        np.testing.assert_array_equal(np.signbit(got[ok]), np.signbit(want[ok]))
        return
    np.testing.assert_array_equal(got, want)


def test_segment_reduce_histogram():
    """``_dest_counts``' use: an 8-slot histogram of live destinations."""
    rng = np.random.default_rng(2)
    dest = rng.integers(0, 8, 10_000)
    live = rng.random(10_000) > 0.3
    got = K.segment_reduce(torch.from_numpy(live.astype(np.int64)),
                           torch.from_numpy(dest), 8, "sum")
    np.testing.assert_array_equal(got.numpy(), np.bincount(dest[live], minlength=8))


def test_umod_is_unsigned():
    rng = np.random.default_rng(5)
    h = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 100_000,
                     dtype=np.int64)
    h[:4] = [-1, np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0]
    assert (h < 0).sum() > 40_000  # bit 63 set
    for n in (2, 3, 7, 8, 64):
        want = h.view(np.uint64) % np.uint64(n)
        got = K.umod(torch.from_numpy(h), n).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def _group_dict(key, sums, counts, slot_live):
    got = {}
    for k, s, c, lv in zip(*(np.asarray(a) for a in (key, sums, counts, slot_live))):
        if lv:
            k = int(np.int64(k))
            assert k not in got, f"key {k} finalized on two shards"
            got[k] = (int(s), int(c))
    return got


def test_distributed_group_sums_matches_jax(jax_mesh, mesh):
    """The twin of ``test_parallel.py::test_distributed_group_sums``."""
    rng = np.random.default_rng(0)
    n = 1024
    keys = rng.integers(0, 37, n).astype(np.int64)
    vals = rng.integers(0, 100, n).astype(np.int64)
    live = np.ones(n, dtype=bool)
    live[::13] = False
    kb, kn = JK.normalize_key(jnp.asarray(keys), None)
    jk, _, js, jc, jl, jovf = jax_group_sums(
        jax_mesh, WORKER_AXIS, kb, kn, jnp.asarray(live), [jnp.asarray(vals)],
        local_capacity=128, final_capacity=64, bucket_capacity=64)
    tb, tn = K.normalize_key(torch.from_numpy(keys), None)
    tk, _, ts, tc, tl, tovf = distributed_group_sums(
        mesh, tb, tn, torch.from_numpy(live), [torch.from_numpy(vals)],
        local_capacity=128, final_capacity=64, bucket_capacity=64)
    assert not tovf and not jovf
    got = _group_dict(tk, ts[0], tc, tl)
    assert got == _group_dict(jk, js[0], jc, jl)
    want_s, want_c = collections.Counter(), collections.Counter()
    for k, v, lv in zip(keys, vals, live):
        if lv:
            want_s[int(k)] += int(v)
            want_c[int(k)] += 1
    assert got == {k: (want_s[k], want_c[k]) for k in want_s}
    # each key finalizes on the shard that owns its hash, as in JAX
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tk.numpy()[tl.numpy()],
                                  np.asarray(jk).view(np.int64)[np.asarray(jl)])


def test_distributed_group_sums_with_nulls_matches_jax(jax_mesh, mesh):
    """The twin of ``test_parallel.py::test_distributed_group_sums_with_nulls``:
    NULL keys group together."""
    rng = np.random.default_rng(1)
    n = 512
    keys = rng.integers(0, 5, n).astype(np.int64)
    valid = rng.random(n) > 0.2
    vals = np.ones(n, dtype=np.int64)
    live = np.ones(n, dtype=bool)
    kb, kn = JK.normalize_key(jnp.asarray(keys), jnp.asarray(valid))
    jk, jn, js, jc, jl, jovf = jax_group_sums(
        jax_mesh, WORKER_AXIS, kb, kn, jnp.asarray(live), [jnp.asarray(vals)],
        local_capacity=64, final_capacity=64, bucket_capacity=64)
    tb, tn = K.normalize_key(torch.from_numpy(keys), torch.from_numpy(valid))
    tk, tnull, ts, tc, tl, tovf = distributed_group_sums(
        mesh, tb, tn, torch.from_numpy(live), [torch.from_numpy(vals)],
        local_capacity=64, final_capacity=64, bucket_capacity=64)
    assert not tovf and not jovf
    lv = tl.numpy()
    null_groups = [int(c) for c, nl, l in zip(tc.numpy(), tnull.numpy(), lv) if l and nl]
    assert null_groups == [int((~valid).sum())]
    np.testing.assert_array_equal(lv, np.asarray(jl))
    np.testing.assert_array_equal(tnull.numpy()[lv], np.asarray(jn)[lv])
    np.testing.assert_array_equal(tc.numpy()[lv], np.asarray(jc)[lv])


def test_distributed_group_sums_reports_overflow(mesh):
    """Too small a final table (or bucket) reports overflow instead of
    dropping groups silently."""
    keys = torch.arange(512, dtype=torch.int64) % 200
    kb, kn = K.normalize_key(keys, None)
    live = torch.ones(512, dtype=torch.bool)
    *_, ovf = distributed_group_sums(mesh, kb, kn, live, [keys], 64, 8, 64)
    assert ovf


def test_q1_step_matches_jax():
    """The twin of ``__graft_entry__.entry()``'s q1_step over
    ``_q1_example_args()``: equal groups and int64 sums."""
    import __graft_entry__ as graft

    fn, args = graft.entry()
    want = [np.asarray(a) for a in jax.jit(fn)(*args)]
    got = q1_step(*[torch.from_numpy(np.array(a)) for a in args])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got[2].sum()) == 6  # (returnflag, linestatus) pairs
