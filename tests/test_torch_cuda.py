"""The port's hand-written CUDA kernels against their plain torch versions.

Needs an NVIDIA GPU with the CUDA toolkit: every test skips without one.
The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Inputs are made with numpy from fixed seeds; the same tensors go through
each kernel on the card and through its plain version on the CPU.
Integer outputs must be equal, as must min/max results (NaN equal to
NaN, the sign of zero kept); float64 sums agree to relative 1e-12.
"""

import numpy as np
import pytest
import torch

from test_torch_join_keys import KEY_SETS, join_key_set
from test_torch_skew_cases import (EXPAND_CASES, QUANT_CASES, expand_case,
                                   quant_case)
from test_torch_tile_cases import arg_case, peer_case
from trino_tpu_torch.exec import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _group_inputs(n, n_keys, dead_frac, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(n_keys, 1), size=n).astype(np.int64)
    live = rng.random(n) >= dead_frac
    return keys, live


def _assert_info_equal(a, b):
    for name, x, y in zip(K.GroupInfo._fields, a, b):
        assert (x is None) == (y is None), name
        assert x is None or torch.equal(x.cpu(), y.cpu()), name


@pytest.mark.parametrize("n,n_keys,capacity,widths,dead", [
    (0, 1, 8, (8,), 0.3),
    (1, 1, 8, (8,), 0.3),
    (7, 3, 8, None, 0.3),
    (5000, 4, 1024, (3,), 0.3),          # Q1-like: few groups, packed hot path
    (5000, 3000, 1024, (12,), 0.3),      # overflow: num_groups > capacity
    (100_000, 40_000, 65536, None, 0.3),  # unpacked path, many groups
    (300_000, 250_000, 393216, (63,), 0.3),  # liveness folded into bit 63
    # ~2,400 tiles of 2048 rows: the look-back crosses many tiles
    (5_000_000, 1_500_000, 2_097_152, (21,), 0.03),
    (5_000_000, 4, 16, (3,), 0.03),
    (200_000, 150_000, 65536, (18,), 0.3),  # overflow across ~100 tiles
    (50_000, 100, 128, (7,), 1.0),        # every row dead
    (50_000, 100, 128, None, 1.0),        # every row dead, unpacked
])
def test_group_ids_kernel(cuda, n, n_keys, capacity, widths, dead):
    keys, live = _group_inputs(n, n_keys, dead, seed=n + n_keys)
    if widths == (63,):
        keys = keys | (1 << 62)  # exercise the top key bit
    cpu_bits = (torch.from_numpy(keys),)
    cpu_live = torch.from_numpy(live)
    want = K.group_by([(cpu_bits[0], None)], cpu_live, capacity, widths=widths,
                      with_rep=True)
    K.group_ids.launches = 0
    got = K.group_by(
        [(cpu_bits[0].to(cuda), None)], cpu_live.to(cuda),
        capacity, widths=widths, with_rep=True,
    )
    torch.cuda.synchronize()
    assert K.group_ids.launches == 1
    _assert_info_equal(got, want)


@pytest.mark.parametrize("n,n_keys,dtype", [
    (0, 1, torch.int64),
    (7, 3, torch.int64),
    (200_000, 4, torch.int64),
    (200_000, 60_000, torch.int64),
    (200_000, 4, torch.float64),
    (200_000, 60_000, torch.float64),
])
def test_seg_sum_kernel(cuda, n, n_keys, dtype):
    keys, live = _group_inputs(n, n_keys, 0.2, seed=7 + n_keys)
    rng = np.random.default_rng(n)
    cap = 1 << max(int(n_keys).bit_length(), 3)
    info = K.group_by(
        [(torch.from_numpy(keys), None)], torch.from_numpy(live), cap,
        widths=(64,),
    )
    if dtype == torch.int64:
        vals = torch.from_numpy(
            rng.integers(-(1 << 62), 1 << 62, size=n, dtype=np.int64)
        )
    else:
        vals = torch.from_numpy(rng.normal(size=n) * 1e6)
    want = K.seg_sum(vals, info.starts, info.ends)
    got = K.seg_sum(vals.to(cuda), info.starts.to(cuda), info.ends.to(cuda))
    torch.cuda.synchronize()
    if dtype == torch.int64:
        assert torch.equal(got.cpu(), want)
    else:
        assert torch.allclose(got.cpu(), want, rtol=1e-12, atol=1e-6)


@pytest.mark.parametrize("keys,m,n", [
    ((4, False, 0.0), 0, 5),
    ((4, False, 0.0), 64, 0),
    ((10, True, 1.0), 64, 100),        # all-dead build side
    ((30_000, True, 0.2), 20_000, 80_000),
    ((150_000, False, 0.1), 150_000, 600_000),
    # K3's adversarial key sets (test_torch_join_keys.py): an outlier that
    # degenerates the key-range directory, a hot key, hashed u64 keys,
    # probes all outside the build range, one live build row, sorted probes
    *[(name, m, n) for name in KEY_SETS
      for m, n in ((3000, 4000), (400_000, 1_600_000))],
    # K4 alone on its adversarial cases (test_torch_skew_cases.py): no
    # probe rows, no matches, out_cap equal to and below the total, heavy
    # rows on tile edges, one hot row, many rows wider than a tile
    *[(name, None, None) for name in EXPAND_CASES],
])
def test_join_kernels(cuda, keys, m, n):
    if keys in EXPAND_CASES:
        order, lo, cnt, out_cap = expand_case(keys, seed=3)
        order, lo, cnt = (torch.from_numpy(x) for x in (order, lo, cnt))
        p, b, live = K.expand_matches(order, lo, cnt, out_cap)
        K.expand_matches.launches = 0
        p_d, b_d, live_d = K.expand_matches(
            order.to(cuda), lo.to(cuda), cnt.to(cuda), out_cap)
        torch.cuda.synchronize()
        assert K.expand_matches.launches == 1
        assert torch.equal(live_d.cpu(), live)
        assert torch.equal(p_d.cpu()[live], p[live])
        assert torch.equal(b_d.cpu()[live], b[live])
        # dead positions hold in-range placeholders
        assert ((p_d >= 0) & (p_d < max(cnt.shape[0], 1))).all()
        assert ((b_d >= 0) & (b_d < max(order.shape[0], 1))).all()
        return
    if isinstance(keys, str):
        bk, bl, pk, pl = join_key_set(keys, m, n, seed=m + n)
    else:
        n_keys, high_bit, build_dead = keys
        rng = np.random.default_rng(m + n)
        bk = rng.integers(0, n_keys, size=m).astype(np.int64)
        pk = rng.integers(0, n_keys, size=n).astype(np.int64)
        if high_bit:
            bk = bk | np.int64(-(1 << 63))
            pk = pk | np.int64(-(1 << 63))
        bl = rng.random(m) >= build_dead
        pl = rng.random(n) >= 0.1
    args = [torch.from_numpy(x) for x in (bk, bl, pk, pl)]
    order, lo, cnt = K.join_ranges(*args)
    K.join_probe.launches = K.expand_matches.launches = 0
    order_d, lo_d, cnt_d = K.join_ranges(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert torch.equal(order_d.cpu(), order)
    assert torch.equal(lo_d.cpu(), lo)
    assert torch.equal(cnt_d.cpu(), cnt)
    total = int(cnt.sum())
    out_cap = max(total, 1) + 5
    p, b, live = K.expand_matches(order, lo, cnt, out_cap)
    p_d, b_d, live_d = K.expand_matches(order_d, lo_d, cnt_d, out_cap)
    torch.cuda.synchronize()
    assert K.join_probe.launches == 1 and K.expand_matches.launches == 1
    assert torch.equal(live_d.cpu(), live)
    assert torch.equal(p_d.cpu()[live], p[live])
    assert torch.equal(b_d.cpu()[live], b[live])


def test_expand_matches_checks_its_scratch(cuda):
    """K4 sizes its look-back words and heavy-row descriptors by its own
    TILE and HEAVY: a buffer shorter than those need is refused at launch,
    not overrun."""
    from trino_tpu_torch.exec import native

    n, cap = 5 * K.EXPAND_TILE + 3, 4096
    i64 = dict(dtype=torch.int64, device=cuda)
    order = torch.arange(64, **i64)
    lo = torch.zeros(n, **i64)
    cnt = torch.zeros(n, **i64)
    cnt[:: 97] = 1
    state = torch.empty(-(-n // K.EXPAND_TILE) + 3, **i64)
    heavy = torch.empty((min(n, cap // (K.EXPAND_HEAVY + 1) + 1), 5), **i64)
    outs = (torch.empty(cap, **i64), torch.empty(cap, **i64),
            torch.empty(cap, dtype=torch.bool, device=cuda))
    for st, hv in ((state[:-1], heavy), (state, heavy[:-1])):
        with pytest.raises(RuntimeError, match="CUDA error"):
            native.call("expand_matches", "expand_matches_launch", order, lo,
                        cnt, n, cap, st, st.shape[0], hv, hv.shape[0], *outs)
    native.call("expand_matches", "expand_matches_launch", order, lo, cnt, n,
                cap, state, state.shape[0], heavy, heavy.shape[0], *outs)
    torch.cuda.synchronize()
    want = K.expand_matches_plain(order.cpu(), lo.cpu(), cnt.cpu(), cap)
    assert torch.equal(outs[2].cpu(), want[2])
    assert torch.equal(outs[0].cpu()[want[2]], want[0][want[2]])


def _range_any_inputs(n, hot, seed):
    rng = np.random.default_rng(seed)
    cnt = rng.integers(1, 8, size=n).astype(np.int64)
    if hot and n:
        cnt[n // 2] = 3 * int(cnt.sum())  # one probe owns 3/4 of the positions
    total = int(cnt.sum())
    live = rng.random(total + 11) >= 0.5
    if hot and n:
        # dead but for the hot range's last position: the whole range is read
        off = int(cnt[: n // 2].sum())
        live[off: off + cnt[n // 2]] = False
        live[off + cnt[n // 2] - 1] = True
    return cnt, live


@pytest.mark.parametrize("n,hot", [
    (0, False), (1, False), (1, True), (5000, False), (5000, True),
    (400_000, False), (400_000, True),
])
def test_range_any_kernel(cuda, n, hot):
    cnt, live = _range_any_inputs(n, hot, seed=n + hot)
    c, lv = torch.from_numpy(cnt), torch.from_numpy(live)
    want = K.range_any(c, lv)
    K.range_any.launches = 0
    got = K.range_any(c.to(cuda), lv.to(cuda))
    torch.cuda.synchronize()
    assert K.range_any.launches == 1
    assert torch.equal(got.cpu(), want)
    # out_live shorter than the expansion: range ends clamp
    short = lv[: max(lv.shape[0] // 3, 1)].contiguous()
    assert torch.equal(K.range_any(c.to(cuda), short.to(cuda)).cpu(),
                       K.range_any(c, short))


@pytest.mark.parametrize("m,capacity,hot", [
    (0, 5, False), (1, 1, False), (5000, 700, False),
    (600_000, 150_000, False), (600_000, 150_000, True),
])
def test_scatter_any_kernel(cuda, m, capacity, hot):
    rng = np.random.default_rng(m + capacity)
    idx = rng.integers(0, capacity, size=m).astype(np.int64)
    flags = rng.random(m) >= 0.5
    idx[~flags] = 0  # placeholders under dead flags
    if hot:
        idx[: m // 2] = capacity - 1
    i, f = torch.from_numpy(idx), torch.from_numpy(flags)
    want = K.scatter_any(i, f, capacity)
    K.scatter_any.launches = 0
    got = K.scatter_any(i.to(cuda), f.to(cuda), capacity)
    torch.cuda.synchronize()
    assert K.scatter_any.launches == 1
    assert torch.equal(got.cpu(), want)


def _hash_parts(case, n, seed):
    """Key parts [(data, valid|None)] as numpy arrays for K7."""
    rng = np.random.default_rng(seed)
    if case == "two_int64":  # Q9: l_partkey, l_suppkey
        return [(rng.integers(0, 1 << 40, size=n).astype(np.int64), None),
                (rng.integers(-(1 << 62), 1 << 62, size=n).astype(np.int64), None)]
    if case == "float_nullable":
        f = rng.normal(size=n)
        if n:
            f[:: max(n // 4, 1)] = np.nan
            f[1:: max(n // 5, 1)] = -0.0
            f[2:: max(n // 6, 1)] = 0.0
        return [(rng.integers(0, 9, size=n).astype(np.int64), None),
                (f, None),
                (rng.integers(-5, 5, size=n).astype(np.int32), rng.random(n) >= 0.3)]
    if case == "narrow":
        return [(rng.integers(-100, 100, size=n).astype(np.int8), None),
                (rng.integers(-999, 999, size=n).astype(np.int16), rng.random(n) >= 0.5),
                (rng.random(n) >= 0.5, None),
                (rng.normal(size=n).astype(np.float32), None)]
    if case == "many":  # more parts than one launch takes
        return [(rng.integers(0, 3, size=n).astype(np.int64), None)
                for _ in range(K.MAX_KEY_PARTS + 3)]
    raise AssertionError(case)


@pytest.mark.parametrize("case,n", [
    ("two_int64", 0), ("two_int64", 1), ("two_int64", 100_000),
    ("float_nullable", 50_000), ("narrow", 50_000), ("many", 3000),
])
def test_hash_keys_kernel(cuda, case, n):
    parts = _hash_parts(case, n, seed=n + len(case))
    cpu = [(torch.from_numpy(d), None if v is None else torch.from_numpy(v))
           for d, v in parts]
    want = K.hash_keys(cpu)
    K.hash_keys.launches = 0
    got = K.hash_keys([(d.to(cuda), None if v is None else v.to(cuda)) for d, v in cpu])
    torch.cuda.synchronize()
    assert K.hash_keys.launches == -(-len(parts) // K.MAX_KEY_PARTS)
    assert torch.equal(got.cpu(), want)


def test_hash_keys_kernel_strided_lane(cuda):
    # a hash-coded varchar's hash lane is a stride-2 view of [n, 2]
    rng = np.random.default_rng(3)
    lanes = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, size=(5000, 2)))
    other = torch.from_numpy(rng.integers(0, 50, size=5000).astype(np.int64))
    want = K.hash_keys([(lanes[:, 0], None), (other, None)])
    d = lanes.to(cuda)
    got = K.hash_keys([(d[:, 0], None), (other.to(cuda), None)])
    assert torch.equal(got.cpu(), want)


def _pack_case(case, n, seed):
    """(cols [(data, valid|None)], live, widths) for K8."""
    rng = np.random.default_rng(seed)
    live = rng.random(n) >= 0.1
    if case == "folded":  # Q18: l_orderkey narrowed, live bit folded in
        return [(rng.integers(0, 1 << 26, size=n).astype(np.int64), None)], live, (26,)
    if case == "three_nullable":
        cols = [(rng.integers(0, 1 << 10, size=n).astype(np.int32), rng.random(n) >= 0.2),
                (rng.integers(0, 25, size=n).astype(np.int64), rng.random(n) >= 0.2),
                (rng.integers(0, 1 << 20, size=n).astype(np.int64), rng.random(n) >= 0.2)]
        return cols, live, (10, 5, 20)
    if case == "packed63":
        k = rng.integers(0, 40, size=n).astype(np.int64) | np.int64(1 << 61)
        return [(k, rng.random(n) >= 0.2)], live, (62,)
    if case == "multiword":
        cols = [(rng.integers(-(1 << 62), 1 << 62, size=n).astype(np.int64), None),
                (rng.normal(size=n), None),
                (rng.integers(0, 9, size=n).astype(np.int16), rng.random(n) >= 0.5),
                (rng.random(n) >= 0.5, None)]
        cols[1][0][:: 7] = np.nan
        cols[1][0][1:: 7] = -0.0
        return cols, live, (64, 64, 4, 1)
    if case == "many_flags":  # 70 one-bit keys: two words
        cols = [(rng.random(n) >= 0.5, None) for _ in range(70)]
        return cols, live, (1,) * 70
    raise AssertionError(case)


@pytest.mark.parametrize("case,n", [
    ("folded", 0), ("folded", 1), ("folded", 200_000),
    ("three_nullable", 200_000), ("packed63", 50_000), ("multiword", 50_000),
    ("many_flags", 5000),
])
def test_pack_words_kernel(cuda, case, n):
    cols, live, widths = _pack_case(case, n, seed=n + len(case))
    cpu = [(torch.from_numpy(d), None if v is None else torch.from_numpy(v)) for d, v in cols]
    lv = torch.from_numpy(live)
    want = K.pack_keys(cpu, lv, widths)
    K.pack_keys.launches = 0
    got = K.pack_keys(
        [(d.to(cuda), None if v is None else v.to(cuda)) for d, v in cpu],
        lv.to(cuda), widths,
    )
    torch.cuda.synchronize()
    assert K.pack_keys.launches == len(want[0])  # one launch per word
    assert got[1:] == want[1:] and len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a.cpu(), b)
    # the whole GROUP BY (K8, torch.sort, K1) equals the CPU's
    capacity = 1 << 18
    _assert_info_equal(
        K.group_by([(d.to(cuda), None if v is None else v.to(cuda)) for d, v in cpu],
                   lv.to(cuda), capacity, widths),
        K.group_by(cpu, lv, capacity, widths),
    )


def _nan_equal(a, b):
    """Exact equality with NaN equal to NaN and the sign of zero kept."""
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return False
        keep = ~torch.isnan(a)
        a, b = a[keep], b[keep]
        if not torch.equal(torch.signbit(a), torch.signbit(b)):
            return False
    return torch.equal(a, b)


@pytest.mark.parametrize("n,n_keys,dtype", [
    (0, 1, torch.int64),
    (7, 3, torch.float64),
    (200_000, 4, torch.int64),
    (200_000, 60_000, torch.int64),
    (200_000, 4, torch.float64),
    (200_000, 60_000, torch.float64),
    (200_000, 60_000, torch.int8),
    (200_000, 60_000, torch.int32),
    (200_000, 600, torch.float32),
])
def test_seg_minmax_kernel(cuda, n, n_keys, dtype):
    keys, live = _group_inputs(n, n_keys, 0.2, seed=11 + n_keys)
    rng = np.random.default_rng(n + 1)
    cap = 1 << max(int(n_keys).bit_length(), 3)
    info = K.group_by(
        [(torch.from_numpy(keys), None)], torch.from_numpy(live), cap,
        widths=(64,),
    )
    if dtype.is_floating_point:
        v = rng.normal(size=n).round(1)
        if n > 7:
            v[rng.random(n) < 1e-3] = np.nan  # a few groups hold a NaN
            v[rng.random(n) < 0.05] = -0.0
        vals = torch.from_numpy(v).to(dtype)
        fills = (float("inf"), float("-inf"))
    else:
        info_t = torch.iinfo(dtype)
        vals = torch.from_numpy(rng.integers(info_t.min, info_t.max, size=n)).to(dtype)
        fills = (info_t.max, info_t.min)
    contrib = torch.from_numpy(rng.random(n) >= 0.3)
    for is_min, fill in zip((True, False), fills):
        masked = torch.where(contrib, vals, torch.tensor(fill, dtype=dtype))
        want = K.seg_minmax(masked, info.starts, info.ends, fill, is_min)
        K.seg_minmax.launches = 0
        got = K.seg_minmax(masked.to(cuda), info.starts.to(cuda),
                           info.ends.to(cuda), fill, is_min)
        torch.cuda.synchronize()
        assert K.seg_minmax.launches == 1
        assert got.dtype == dtype
        assert _nan_equal(got, want), (is_min, dtype)


def _order_keys(n, seed):
    """ORDER BY keys of every supported dtype: NaN, +-0.0, NULLs,
    INT64_MIN under DESC, and about 10% dead rows."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n).round(1)
    if n:
        f[:: max(n // 5, 1)] = np.nan
        f[1:: max(n // 4, 1)] = -0.0
    i64 = rng.integers(-5, 5, size=n).astype(np.int64)
    if n:
        i64[:: max(n // 3, 1)] = np.iinfo(np.int64).min
    i32 = rng.integers(-5, 5, size=n).astype(np.int32)
    if n:
        i32[:: max(n // 3, 1)] = np.iinfo(np.int32).min
    keys = [
        (f, rng.random(n) >= 0.2, False, True),
        (i64, None, False, False),
        (i32, rng.random(n) >= 0.2, True, False),
        (rng.random(n) >= 0.5, None, False, True),
        (f.astype(np.float32), None, True, False),
        (rng.integers(-3, 3, size=n).astype(np.int16), None, False, False),
        (rng.integers(-3, 3, size=n).astype(np.int8), None, True, True),
    ]
    return keys, rng.random(n) >= 0.1


@pytest.mark.parametrize("n,repeat", [
    (0, 1), (1, 1), (7, 1), (100_000, 1),
    (5000, 6),  # 42 keys: more than one launch takes
])
def test_order_words_kernel(cuda, n, repeat):
    keys, live = _order_keys(n, seed=n)
    keys = keys * repeat
    cpu = [(torch.from_numpy(d), None if v is None else torch.from_numpy(v), a, f)
           for d, v, a, f in keys]
    lv = torch.from_numpy(live)
    want = K.order_words(cpu, lv)
    dev = [(d.to(cuda), None if v is None else v.to(cuda), a, f) for d, v, a, f in cpu]
    K.order_words.launches = 0
    got = K.order_words(dev, lv.to(cuda))
    torch.cuda.synchronize()
    assert K.order_words.launches == -(-len(keys) // K.MAX_KEY_PARTS)
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    for a, b in zip(got[1], want[1]):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a.cpu(), b)
    assert torch.equal(got[2].cpu(), want[2])
    assert torch.equal(K.sort_perm(dev, lv.to(cuda)).cpu(), K.sort_perm(cpu, lv))


def _window_case(n, seed, huge=False):
    """Sorted window rows: partition ids (non-decreasing, dead rows last
    under one id), each row's partition start and end, and frames inside
    the partitions (prefix frames when ``prefix``); with ``huge``, half
    the live rows form one partition."""
    rng = np.random.default_rng(seed)
    n_live = int(n * 0.9)
    gid = np.repeat(np.arange(n), rng.integers(1, 40, size=n))[:n_live]
    if huge and n_live:
        gid[: n_live // 2] = 0
        gid = np.maximum.accumulate(gid)
    gid = np.concatenate([gid, np.full(n - n_live, n)]).astype(np.int64)
    pos = np.arange(n)
    first = np.r_[True, gid[1:] != gid[:-1]][:n]
    pstart = np.maximum.accumulate(np.where(first, pos, 0)) if n else pos
    last = np.r_[gid[1:] != gid[:-1], True][:n]
    pend = (np.minimum.accumulate(np.where(last, pos + 1, n + 1)[::-1])[::-1]
            if n else pos)
    a = pstart + rng.integers(0, 30, size=n)
    b = pstart + rng.integers(0, 30, size=n)
    lo = np.clip(np.minimum(a, b), pstart, pend)
    hi = np.clip(np.maximum(a, b) + 1, pstart, pend)
    t = torch.from_numpy
    return rng, t(gid), t(pstart.astype(np.int64)), t(pend.astype(np.int64)), t(lo), t(hi)


@pytest.mark.parametrize("n,keys", [
    (0, "int"), (1, "int"), (7, "none"),
    (300_000, "int"), (300_000, "float_limbs"),
])
def test_window_peers_kernel(cuda, n, keys):
    rng, gid, _ps, pend, _lo, _hi = _window_case(n, seed=n + 1)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int64))
    cols = []
    if keys == "int":
        cols = [(torch.from_numpy(rng.integers(0, 4, size=n).astype(np.int64)),
                 torch.from_numpy(rng.random(n) >= 0.2))]
    elif keys == "float_limbs":
        f = rng.choice(np.array([0.0, -0.0, np.nan, 2.5]), size=n)
        limbs = torch.from_numpy(rng.integers(0, 2, size=(n, 2)).astype(np.int64))
        cols = [(torch.from_numpy(f), None),
                (limbs[:, 0], torch.from_numpy(rng.random(n) >= 0.3)),
                (limbs[:, 1], None),
                (torch.from_numpy(rng.integers(0, 2, size=n).astype(np.int32)), None)]
    want = K.window_peers(gid, cols, perm, pend, with_dense=True)
    dev = [(d.to(cuda), None if v is None else v.to(cuda)) for d, v in cols]
    K.window_peers.launches = 0
    got = K.window_peers(gid.to(cuda), dev, perm.to(cuda), pend.to(cuda),
                         with_dense=True)
    torch.cuda.synchronize()
    assert K.window_peers.launches == 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


#: W1 around its 2048-row tiles (test_torch_tile_cases.py): n at a
#: multiple of 2048 and one row either side, peer groups of ~100K rows,
#: one peer group over every row (no key part), every row a boundary, 32
#: key parts
PEER_TILE_SHAPES = [
    ("edge", 2048 * 100 - 1), ("edge", 2048 * 100), ("edge", 2048 * 100 + 1),
    ("long", 1_000_000), ("one_group", 1_000_000), ("unique", 300_000),
    ("keys32", 50_000),
]


@pytest.mark.parametrize("with_dense", [False, True])
@pytest.mark.parametrize("name,n", PEER_TILE_SHAPES)
def test_window_peers_tile_cases(cuda, name, n, with_dense):
    t = torch.from_numpy
    gid, pend, perm, keys = peer_case(name, n, seed=n)
    gid, pend, perm = t(gid), t(pend), t(perm)
    cols = [(t(d), None if v is None else t(v)) for d, v in keys]
    want = K.window_peers(gid, cols, perm, pend, with_dense=with_dense)
    dev = [(d.to(cuda), None if v is None else v.to(cuda)) for d, v in cols]
    K.window_peers.launches = 0
    got = K.window_peers(gid.to(cuda), dev, perm.to(cuda), pend.to(cuda),
                         with_dense=with_dense)
    torch.cuda.synchronize()
    assert K.window_peers.launches == 1
    for out, a, b in zip(("peer_start", "peer_end", "dense"), got, want):
        assert (a is None) == (b is None), out
        assert a is None or torch.equal(a.cpu(), b), out


def _long_frames(n, case, rng):
    """Sorted partition ids and frames for W2's multi-tile cases:
    ``whole``, one partition over the column with running frames;
    ``long``, partitions of 5,000-40,000 rows (many 2048-row tiles) with
    offset frames; ``reach``, offset frames up to 3,000 rows either side,
    past the row's tile."""
    if case == "whole":
        gid = np.zeros(n, dtype=np.int64)
    else:
        parts = n // 5_000 + 1
        gid = np.repeat(np.arange(parts), rng.integers(5_000, 40_000, size=parts))[:n]
        gid = np.concatenate([gid, np.full(n - len(gid), parts)]).astype(np.int64)
    pos = np.arange(n)
    first = np.r_[True, gid[1:] != gid[:-1]]
    pstart = np.maximum.accumulate(np.where(first, pos, 0))
    last = np.r_[gid[1:] != gid[:-1], True]
    pend = np.minimum.accumulate(np.where(last, pos + 1, n + 1)[::-1])[::-1]
    if case == "whole":
        lo, hi = pstart.copy(), pos + 1
    else:
        reach = 3_000 if case == "reach" else 40
        lo = np.clip(pos - rng.integers(0, reach, size=n), pstart, pend)
        hi = np.clip(pos + rng.integers(1, reach, size=n), pstart, pend)
    t = torch.from_numpy
    return t(gid), t(lo), t(hi)


@pytest.mark.parametrize("n,huge", [(0, False), (5, False), (300_000, False),
                                    (300_000, True), (300_000, "mixed8"),
                                    (1_000_000, "whole"), (1_000_000, "long"),
                                    (1_000_000, "reach"), (300_000, "repeat")])
def test_range_sum_kernel(cuda, n, huge):
    """W2: int64 lanes bit for bit, float64 lanes to relative 1e-9 of the
    plain version (NaN where it has NaN). ``huge``: a partition of 1e18s;
    ``mixed8``: 8 lanes, int64 and float64 in turn; ``whole``, ``long``,
    ``reach``: see ``_long_frames``; ``repeat``: two calls give equal
    float64 bits."""
    if huge in ("whole", "long", "reach"):
        rng = np.random.default_rng(n + len(huge))
        gid, lo, hi = _long_frames(n, huge, rng)
    else:
        rng, gid, _ps, _pe, lo, hi = _window_case(n, seed=n + 2, huge=huge is True)
    ints = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, size=n))
    f = rng.uniform(1.0, 1000.0, size=n)
    if huge is True and n:
        f[gid.numpy() == 0] = 1e18  # the huge partition beside small ones
    lanes = [ints, torch.from_numpy(f), torch.from_numpy(rng.integers(0, 1 << 32, size=n))]
    if huge == "mixed8":
        g = rng.uniform(1.0, 1e6, size=n)
        g[rng.random(n) < 1e-4] = np.nan
        g[gid.numpy() == gid[0].item()] = 1e18
        lanes += [torch.from_numpy(g),
                  torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, size=n)),
                  torch.from_numpy(rng.uniform(1.0, 10.0, size=n)),
                  torch.ones(n, dtype=torch.int64),
                  torch.from_numpy(rng.exponential(1e3, size=n))]
    want = K.range_sum(lanes, gid, lo, hi)
    K.range_sum.launches = 0
    dev = [x.to(cuda) for x in lanes]
    got = K.range_sum(dev, gid.to(cuda), lo.to(cuda), hi.to(cuda))
    torch.cuda.synchronize()
    assert K.range_sum.launches == 1
    for a, b in zip(got, want):
        if b.dtype == torch.int64:
            assert torch.equal(a.cpu(), b)
        else:
            # float64: a segmented scan in another order of addition
            torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=0, equal_nan=True)
    if huge == "repeat":
        again = K.range_sum(dev, gid.to(cuda), lo.to(cuda), hi.to(cuda))
        for a, b in zip(got, again):
            assert torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.parametrize("n,dtype", [
    (0, "int64"), (9, "float64"), (300_000, "int64"), (300_000, "float64"),
    (300_000, "limbs"),
])
def test_range_minmax_kernel(cuda, n, dtype):
    rng, gid, pstart, _pe, _lo, hi = _window_case(n, seed=n + 3)
    lo = pstart  # prefix frames
    contrib = rng.random(n) >= 0.2
    for is_min in (True, False):
        if dtype == "limbs":
            wide = rng.integers(-(1 << 40), 1 << 40, size=n)
            data = np.stack([wide >> 32, wide & 0xFFFFFFFF], axis=-1)
            fill = K._limb_fill(is_min)
            vals = torch.from_numpy(np.where(contrib[:, None], data, np.asarray(fill)))
        elif dtype == "int64":
            fill = (1 << 63) - 1 if is_min else -(1 << 63)
            vals = torch.from_numpy(np.where(contrib, rng.integers(-99, 99, size=n), fill))
        else:
            fill = float("inf") if is_min else float("-inf")
            x = rng.choice(np.array([-1.0, -0.0, 0.0, 3.5, np.nan]), p=[.3, .2, .2, .29, .01],
                           size=n)
            vals = torch.from_numpy(np.where(contrib, x, fill))
        want = K.range_minmax(vals, gid, lo, hi, fill, is_min)
        K.range_minmax.launches = 0
        got = K.range_minmax(vals.to(cuda), gid.to(cuda), lo.to(cuda), hi.to(cuda),
                             fill, is_min)
        torch.cuda.synchronize()
        assert K.range_minmax.launches == 1
        assert _nan_equal(got, want), (dtype, is_min)


@pytest.mark.parametrize("n,dtype", [(0, "int64"), (6, "float64"),
                                     (300_000, "int64"), (300_000, "float64")])
def test_seg_searchsorted_kernel(cuda, n, dtype):
    rng, gid, pstart, pend, _lo, _hi = _window_case(n, seed=n + 4, huge=True)
    w = np.empty(n, dtype=np.int64)
    for s in np.unique(pstart.numpy()):
        e = int(pend[s])
        w[s:e] = np.sort(rng.integers(-50, 50, size=e - s))
    target = w + rng.integers(-6, 7, size=n)
    w, target = torch.from_numpy(w), torch.from_numpy(target)
    if dtype == "float64":
        w, target = w.double() / 2, target.double() / 2
    for left in (True, False):
        want = K.seg_searchsorted(w, target, pstart, pend, left)
        K.seg_searchsorted.launches = 0
        got = K.seg_searchsorted(w.to(cuda), target.to(cuda), pstart.to(cuda),
                                 pend.to(cuda), left)
        torch.cuda.synchronize()
        assert K.seg_searchsorted.launches == 1
        assert torch.equal(got.cpu(), want)


def test_tiny_tpcds_and_window_statements_on_card(cuda):
    """TPC-DS (the SMOKE_LOCAL and window queries, q51 over 1999 and its
    totals, the RANGE offset window) and the TPC-H window and set-operation
    statements give the same rows on cuda as on cpu."""
    from trino_tpu_torch.connectors.tpcds.queries import QUERIES
    from trino_tpu_torch.engine import QueryRunner
    from trino_tpu_torch.testing import numpy_reference as R
    from trino_tpu_torch.testing.statements import WINDOW_STATEMENTS

    names = [
        "q3", "q7", "q19", "q25", "q42", "q52", "q55", "q68", "q72", "q95",
        "q96", "q98", "q12", "q20", "q36", "q44", "q47", "q49", "q51", "q53",
        "q57", "q63", "q67", "q70", "q86", "q89",
    ]
    runs = [
        (QueryRunner.tpcds("tiny"), QueryRunner.tpcds("tiny", device="cpu"),
         [QUERIES[q] for q in names]
         + [R.q51_sql(108), R.q51_totals_sql(108), R.RANGE7_SQL]),
        (QueryRunner.tpch("tiny"), QueryRunner.tpch("tiny", device="cpu"),
         list(WINDOW_STATEMENTS.values())),
    ]
    for gpu, cpu, statements in runs:
        assert gpu.device.type == "cuda"
        for sql in statements:
            got, want = gpu.execute(sql).rows, cpu.execute(sql).rows
            assert len(got) == len(want), sql
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    if isinstance(b, float):
                        # float sums add in another order on the card
                        assert a == b or abs(a - b) <= 1e-9 * abs(b), (sql, g, w)
                    else:
                        assert type(a) is type(b) and a == b, (sql, g, w)


def test_tiny_queries_on_card(cuda):
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.engine import QueryRunner
    from trino_tpu_torch.testing.statements import JOIN_STATEMENTS, STRING_STATEMENTS

    gpu = QueryRunner.tpch("tiny")
    cpu = QueryRunner.tpch("tiny", device="cpu")
    assert gpu.device.type == "cuda"
    statements = {**QUERIES, **JOIN_STATEMENTS, **STRING_STATEMENTS}
    for name, sql in statements.items():
        got, want = gpu.execute(sql).rows, cpu.execute(sql).rows
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert len(g) == len(w), name
            for a, b in zip(g, w):
                if isinstance(b, float):
                    # a DOUBLE (Q17's sum / 7.0): torch on cuda divides
                    # by a scalar as a multiply by its reciprocal, the
                    # CPU divides: a few ulps apart
                    assert abs(a - b) <= 1e-12 * abs(b), (name, g, w)
                else:
                    assert type(a) is type(b) and a == b, (name, g, w)


def test_tiny_hash_varchar_on_card(cuda):
    """Hash-coded VARCHAR ([hash64, row id] lanes, as SF10's c_name in
    Q18) gives the same rows on cuda as on cpu."""
    from trino_tpu_torch.engine import QueryRunner
    from trino_tpu_torch.testing.numpy_reference import q18_sql

    statements = [
        q18_sql(250),
        "select count(*) from customer where c_name in "
        "(select c_name from customer where c_acctbal > 0)",
        "select count(*), count(o_comment), count(c_comment) from "
        "(select o_comment from orders where o_orderkey < 100) o "
        "full join customer on o_comment = c_comment",
    ]
    gpu = QueryRunner.tpch("tiny")
    cpu = QueryRunner.tpch("tiny", device="cpu")
    for r in (gpu, cpu):
        r.session.properties["varchar_hash_ndv"] = 1000
    for sql in statements:
        assert gpu.execute(sql).rows == cpu.execute(sql).rows, sql


def _hll_inputs(n, n_groups, kind, seed):
    """(lane, hashed, contrib, group | None): int64 or float64 values to
    hash (NaN, -0.0), precomputed hash lanes with zero low bits, or one
    hot value in every row."""
    rng = np.random.default_rng(seed)
    contrib = rng.random(n) >= 0.2
    hashed = kind in ("hash", "hot")
    if kind == "float64":
        lane = rng.normal(size=n).round(2)
        lane[::97] = np.nan
        lane[1::89] = -0.0
    elif kind == "int64":
        lane = rng.integers(0, max(n // 3, 1), size=n).astype(np.int64)
    elif kind == "hot":
        lane = np.full(n, 0x1234_5678_9ABC_DEF0, dtype=np.int64)
    else:
        lane = rng.integers(-(1 << 63), (1 << 63) - 1, size=n, dtype=np.int64)
        lane[:8] = (np.arange(8, dtype=np.int64) << 55)[:n]  # h << b == 0
    group = None
    if n_groups > 1:
        group = rng.integers(0, n_groups, size=n).astype(np.int64)
    elif n_groups == 0:  # the grouped form with one group holding every row
        group = np.zeros(n, dtype=np.int64)
    return (torch.from_numpy(lane), hashed, torch.from_numpy(contrib),
            None if group is None else torch.from_numpy(group))


@pytest.mark.parametrize("n,n_groups,m,kind", [
    (0, 1, 4096, "hash"),
    (1, 1, 4096, "int64"),
    (300_000, 1, 4096, "int64"),
    (300_000, 1, 4096, "float64"),
    (300_000, 1, 4096, "hot"),
    (300_000, 1, 4096, "hash"),
    (300_000, 0, 512, "hash"),         # one group holding every row
    (300_000, 5000, 512, "hash"),
    (300_000, 5000, 512, "hot"),
    (300_000, 5000, 512, "float64"),
    (8_000_000, 2_000_000, 512, "int64"),  # 2M groups of four rows
])
def test_hll_kernels(cuda, n, n_groups, m, kind):
    lane, hashed, contrib, group = _hll_inputs(n, n_groups, kind, seed=n + m)
    caps = max(n_groups, 1)
    # the plain version runs on the card too (its sort and searches are
    # too large for the host at 2M groups x 512 registers)
    dev = cuda if n > 1_000_000 else torch.device("cpu")
    want = K.hll_registers_plain(
        lane.to(dev), contrib.to(dev), None if group is None else group.to(dev),
        m, caps, hashed,
    )
    K.hll_registers.launches = K.hll_estimate.launches = 0
    got = K.hll_registers(
        lane.to(cuda), contrib.to(cuda), None if group is None else group.to(cuda),
        m, caps, hashed,
    )
    est = K.hll_estimate(got)
    torch.cuda.synchronize()
    assert K.hll_registers.launches == 1 and K.hll_estimate.launches == 1
    assert got.dtype == torch.int8 and got.shape == (caps, m)
    assert torch.equal(got.cpu(), want.cpu())
    assert torch.equal(est.cpu(), K.hll_estimate_plain(want).cpu())


def _arg_inputs(n, n_keys, dtype, seed):
    rng = np.random.default_rng(seed)
    gkey = rng.integers(0, max(n_keys, 1), size=n).astype(np.int64)
    live = rng.random(n) >= 0.1
    contrib = (rng.random(n) >= 0.3) & (gkey % 7 != 3)  # some groups: none
    if dtype == "float64":
        keys = rng.integers(-5, 5, size=n).astype(np.float64)  # ties
        keys[::31] = np.nan
        keys[1::17] = -0.0
        keys[2::23] = np.inf
    elif dtype == "float32":
        keys = rng.normal(size=n).round(1).astype(np.float32)
        keys[::29] = np.nan
        keys[1::13] = -0.0
    elif dtype == "bool":
        keys = rng.random(n) < 0.5
    elif dtype == "int32":
        keys = rng.integers(-9, 9, size=n).astype(np.int32)
    else:
        keys = rng.integers(-3, 3, size=n).astype(np.int64)
        keys[::11] = np.iinfo(np.int64).max  # the would-be sentinels
        keys[1::11] = np.iinfo(np.int64).min
    return gkey, live, contrib, keys


@pytest.mark.parametrize("n,n_keys,dtype", [
    (0, 1, "int64"),
    (7, 3, "float64"),
    (300_000, 1, "int64"),            # one group holding every row
    (300_000, 120, "int64"),
    (300_000, 120, "float64"),
    (300_000, 50_000, "float64"),
    (300_000, 5000, "int32"),
    (300_000, 5000, "bool"),
    (300_000, 5000, "float32"),
    (8_000_000, 2_000_000, "int64"),  # 2M groups of four rows
])
def test_seg_arg_extreme_kernel(cuda, n, n_keys, dtype):
    gkey, live, contrib, keys = _arg_inputs(n, n_keys, dtype, seed=n + n_keys)
    cap = 1 << max(int(n_keys).bit_length(), 3)
    dev = cuda if n > 1_000_000 else torch.device("cpu")
    info = K.group_by(
        [(torch.from_numpy(gkey).to(dev), None)], torch.from_numpy(live).to(dev),
        cap, widths=(64,),
    )
    k, c = torch.from_numpy(keys), torch.from_numpy(contrib)
    info_c = K.GroupInfo(*(None if t is None else t.to(cuda) for t in info))
    for is_min in (True, False):
        want = K.seg_arg_extreme_plain(
            k.to(dev), c.to(dev), info.perm, info.starts, info.ends, is_min,
        )
        K.seg_arg_extreme.launches = 0
        got = K.seg_arg_extreme(k.to(cuda), c.to(cuda), info_c, is_min)
        torch.cuda.synchronize()
        assert K.seg_arg_extreme.launches == 1
        assert torch.equal(got.cpu(), want.cpu()), (is_min, dtype)


#: A3 around its 2048-position tiles (test_torch_tile_cases.py): (case,
#: rows, live rows): the live rows at a multiple of 2048 and one either
#: side; three groups of ~150 tiles each; a group a row; runs of groups
#: with no contributing row longer than a tile; no contributing row
ARG_TILE_SHAPES = [
    ("edge", 2048 * 100 + 500, 2048 * 100 - 1),
    ("edge", 2048 * 100 + 500, 2048 * 100),
    ("edge", 2048 * 100 + 500, 2048 * 100 + 1),
    ("long_group", 1_000_000, None), ("singletons", 300_000, None),
    ("dead_run", 300_000, None), ("none", 100_000, None),
]


@pytest.mark.parametrize("name,n,live_rows", ARG_TILE_SHAPES)
def test_seg_arg_extreme_tile_cases(cuda, name, n, live_rows):
    gkey, live, contrib, keys = arg_case(name, n, seed=n + len(name),
                                         live_rows=live_rows)
    cap = 1 << max(int(gkey.max() + 1).bit_length(), 3)
    info = K.group_by([(torch.from_numpy(gkey), None)], torch.from_numpy(live),
                      cap, widths=(64,))
    info_c = K.GroupInfo(*(None if t is None else t.to(cuda) for t in info))
    k, c = torch.from_numpy(keys), torch.from_numpy(contrib)
    for is_min in (True, False):
        want = K.seg_arg_extreme_plain(k, c, info.perm, info.starts, info.ends, is_min)
        K.seg_arg_extreme.launches = 0
        got = K.seg_arg_extreme(k.to(cuda), c.to(cuda), info_c, is_min)
        torch.cuda.synchronize()
        assert K.seg_arg_extreme.launches == 1
        assert torch.equal(got.cpu(), want), (name, is_min)


def _unaligned(mask, cuda, offset):
    """``mask`` on the card as a contiguous view ``offset`` bytes past an
    allocation, so that its flags do not start a 4-byte word."""
    padded = torch.zeros(mask.shape[0] + offset, dtype=torch.bool, device=cuda)
    padded[offset:] = mask.to(cuda)
    view = padded[offset:]
    assert view.is_contiguous() and view.data_ptr() % 4 == offset
    return view


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_unaligned_flags(cuda, offset):
    """A3's contrib and W1's validity as views 1-3 bytes past a 4-byte
    word: both kernels pack them from the word that holds the first flag,
    with the same results."""
    gkey, live, contrib, keys = arg_case("edge", 100_000 + offset, seed=3,
                                         live_rows=90_000)
    info = K.group_by([(torch.from_numpy(gkey), None)], torch.from_numpy(live),
                      1 << 13, widths=(64,))
    info_c = K.GroupInfo(*(None if t is None else t.to(cuda) for t in info))
    k, c = torch.from_numpy(keys), torch.from_numpy(contrib)
    for is_min in (True, False):
        want = K.seg_arg_extreme_plain(k, c, info.perm, info.starts, info.ends, is_min)
        got = K.seg_arg_extreme(k.to(cuda), _unaligned(c, cuda, offset), info_c, is_min)
        assert torch.equal(got.cpu(), want)
    t = torch.from_numpy
    gid, pend, perm, cols = peer_case("keys32", 70_001 + offset, seed=5)
    cols = [(t(d), None if v is None else t(v)) for d, v in cols]
    want = K.window_peers(t(gid), cols, t(perm), t(pend), with_dense=True)
    dev = [(d.to(cuda), None if v is None else _unaligned(v, cuda, offset))
           for d, v in cols]
    got = K.window_peers(t(gid).to(cuda), dev, t(perm).to(cuda), t(pend).to(cuda),
                         with_dense=True)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_tiny_aggregate_statements_on_card(cuda):
    """The aggregate functions' statements (TPC-H and VALUES) and their
    TPC-DS card statements give the same rows on cuda as on cpu (DOUBLEs
    of double and decimal arguments to relative 1e-9: their sums add in
    another order on the card)."""
    from trino_tpu_torch.engine import QueryRunner
    from trino_tpu_torch.testing.statements import AGGREGATE_STATEMENTS, SKETCH_CARD

    runs = [
        (QueryRunner.tpch("tiny"), QueryRunner.tpch("tiny", device="cpu"),
         AGGREGATE_STATEMENTS),
        (QueryRunner.tpcds("tiny"), QueryRunner.tpcds("tiny", device="cpu"),
         SKETCH_CARD),
    ]
    approx = {"variance_double", "variance_decimal", "ds_q39_inv"}
    for gpu, cpu, statements in runs:
        assert gpu.device.type == "cuda"
        for name, sql in statements.items():
            got, want = gpu.execute(sql).rows, cpu.execute(sql).rows
            assert len(got) == len(want), name
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    if isinstance(b, float) and name in approx:
                        assert abs(a - b) <= 1e-9 * abs(b), (name, g, w)
                    else:
                        assert type(a) is type(b) and a == b, (name, g, w)


# ---- A4-A6: the PARTIAL/FINAL sketches ---------------------------------------


@pytest.mark.parametrize("n,caps,m,hot", [
    (0, 1, 512, False),          # no partial rows
    (0, 8, 4096, False),
    (5, 1, 4096, False),         # global: five chunks x 4096
    (3000, 1024, 512, False),    # grouped, a few partial rows per group
    (200_000, 50_000, 512, False),
    (200_000, 1024, 512, True),  # one group holding every partial row
])
def test_hll_merge_kernel(cuda, n, caps, m, hot):
    rng = np.random.default_rng(n + caps + m)
    states = rng.integers(0, 50, size=(n, m)).astype(np.int8)
    states[rng.random((n, m)) < 0.5] = 0
    contrib = rng.random(n) >= 0.2
    group = None
    if caps > 1:
        group = rng.integers(0, caps + 2, size=n).astype(np.int64)  # some past
        if hot:
            group[:] = 3
    s, c = torch.from_numpy(states), torch.from_numpy(contrib)
    g = None if group is None else torch.from_numpy(group)
    want = K.hll_merge_plain(s, c, g, caps)
    K.hll_merge.launches = 0
    got = K.hll_merge(s.to(cuda), c.to(cuda), None if g is None else g.to(cuda), caps)
    torch.cuda.synchronize()
    assert K.hll_merge.launches == 1
    assert torch.equal(got.cpu(), want)


def _summary_inputs(n, n_keys, dtype, seed):
    rng = np.random.default_rng(seed)
    gkey = rng.integers(0, max(n_keys, 1), size=n).astype(np.int64)
    live = rng.random(n) >= 0.05
    eff = live & (rng.random(n) >= 0.1) & (gkey % 9 != 4)  # some: none
    if dtype == "float64":
        v = rng.integers(-500, 500, size=n) / 8.0
        v[::37] = -0.0
        v[1::101] = np.nan
    elif dtype == "int32":
        v = rng.integers(-1000, 1000, size=n).astype(np.int32)
    else:
        v = rng.integers(-(1 << 60), 1 << 60, size=n).astype(np.int64)
    return gkey, live, eff, v


@pytest.mark.parametrize("n,n_keys,k,dtype", [
    (0, 1, 256, "int64"),
    (1, 1, 1024, "float64"),
    (5000, 0, 1024, "float64"),        # global
    (300_000, 5000, 256, "int64"),
    (300_000, 5000, 256, "float64"),
    (300_000, 120, 256, "int32"),
    (300_000, 1, 1024, "int64"),       # one group holding every row
])
def test_quant_summary_kernel(cuda, n, n_keys, k, dtype):
    from trino_tpu_torch.exec import aggregates as A

    gkey, live, eff, v = _summary_inputs(n, n_keys, dtype, seed=n + k)
    vd, e = torch.from_numpy(v), torch.from_numpy(eff)
    if n_keys == 0:
        info, cap = None, 1
    else:
        cap = 1 << max(int(n_keys).bit_length(), 3)
        info = K.group_by([(torch.from_numpy(gkey), None)],
                          torch.from_numpy(live), cap, widths=(64,))
    p = A._quant_sorted_perm(vd, e, info)
    starts = torch.zeros(1, dtype=torch.int64) if info is None else info.starts
    cnt = A._Reducer(info, cap, e).count()[: starts.shape[0]]
    want = K.quant_summary_plain(vd, p, starts, cnt, k)
    K.quant_summary.launches = 0
    got = K.quant_summary(vd.to(cuda), p.to(cuda), starts.to(cuda), cnt.to(cuda), k)
    torch.cuda.synchronize()
    assert K.quant_summary.launches == 1
    assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))


@pytest.mark.parametrize("rows,n_groups,k,caps", [
    (0, 1, 256, 8),
    (5, 1, 1024, 1),                  # global: five chunks of 1024 points
    (400, 100, 256, 128),
    (20_000, 4000, 256, 4096),        # five chunks of 4000 groups
    (2_000, 1, 256, 8),               # one group holding every partial row
    # the adversarial cases of test_torch_skew_cases.py: points unsorted
    # within rows, -0.0/+0.0 ties inside the target, NaN and infinities,
    # no contributing row, groups with no rows, groups past shared memory
    *[(name, None, None, None) for name in QUANT_CASES],
])
def test_quant_merge_kernel(cuda, rows, n_groups, k, caps):
    if rows in QUANT_CASES:
        states, eff, group, caps = quant_case(rows, seed=5)
        rows = states.shape[0]
    else:
        rng = np.random.default_rng(rows + k)
        pts = np.sort(rng.integers(-300, 300, size=(rows, k)) / 4.0, axis=1)
        pts[rng.random((rows, k)) < 0.01] = -0.0
        pts = np.sort(pts, axis=1)
        cnt = rng.integers(0, 5000, size=rows).astype(np.float64)
        cnt[::7] = 0.0  # a chunk without the group
        states = np.concatenate([pts, cnt[:, None]], axis=1)
        eff = rng.random(rows) >= 0.1
        group = None if caps == 1 else rng.integers(0, n_groups, size=rows).astype(np.int64)
    s, e = torch.from_numpy(states), torch.from_numpy(eff)
    g = None if group is None else torch.from_numpy(group)
    for q in (0.0, 0.5, 0.9, 1.0):
        qt = torch.tensor([q], dtype=torch.float64)
        want, whas = K.quant_merge_plain(s, e, g, caps, qt)
        K.quant_merge.launches = 0
        got, has = K.quant_merge(s.to(cuda), e.to(cuda),
                                 None if g is None else g.to(cuda), caps, qt.to(cuda))
        torch.cuda.synchronize()
        assert K.quant_merge.launches == (1 if rows else 0)
        assert torch.equal(has.cpu(), whas), q
        assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64)), q


def test_budgeted_and_revoked_statements_on_card(cuda):
    """Under an hbm_budget_bytes that streams lineitem, and under a
    per-node cap that revokes a join, the card gives the CPU's rows."""
    from trino_tpu_torch.engine import QueryRunner
    from trino_tpu_torch.exec import spill
    from trino_tpu_torch.testing.statements import BUDGETED_STATEMENTS

    saved = spill.MIN_CHUNK_ROWS
    spill.MIN_CHUNK_ROWS = 8192
    try:
        for props in ({"hbm_budget_bytes": 2 << 20},
                      {"query_max_memory_per_node": str(2 << 20)}):
            gpu = QueryRunner.tpch("tiny")
            cpu = QueryRunner.tpch("tiny", device="cpu")
            for r in (gpu, cpu):
                r.session.properties.update(props)
            stmts = dict(BUDGETED_STATEMENTS)
            stmts["grace"] = (
                "select count(*) from lineitem l1, lineitem l2 "
                "where l1.l_orderkey = l2.l_orderkey "
                "and l1.l_linenumber = l2.l_linenumber", "grace_join", 0.0)
            for name, (sql, _entry, _tol) in stmts.items():
                got, want = gpu.execute(sql).rows, cpu.execute(sql).rows
                assert got == want, (name, props)
    finally:
        spill.MIN_CHUNK_ROWS = saved


#: M1 card cases whose buckets overflow (rows dropped)
_PACK_OVERFLOWS = ("hot", "late", "tiny_bucket")


@pytest.mark.parametrize("rows,n_parts,bucket,kind", [
    (0, 8, 128, "plain"),
    (5, 3, 2, "plain"),
    (300_000, 8, 75_000, "plain"),      # 2x mean occupancy, no overflow
    (300_000, 8, 75_000, "limbs"),      # [n, 2] payload rows of 16 bytes
    (300_000, 8, 75_000, "hot"),        # one destination owns 60%: drops
    (300_000, 64, 9_375, "plain"),
    (100_000, 8, 100_000, "one_dest"),
    (300_000, 8, 75_000, "int32"),      # int32 dest, passed as it is
    (4_097, 8, 1_024, "plain"),         # one row past a multiple of the tile
    (10_000, 1, 10_000, "plain"),       # one destination
    (100_000, 64, 2_000, "plain"),      # 64 destinations, no overflow
    (100_000, 8, 25_000, "all_dead"),   # every row dead: all tails
    (5_000, 8, 1, "tiny_bucket"),       # bucket 1
    (10_000, 8, 1_024, "late"),         # the dropped rows all in the last tile
    (300_000, 8, 75_000, "dirty"),      # tails over memory left as 0xFF
    (50_000, 8, 12_500, "many_cols"),   # 40 payload columns: two batches
])
def test_partition_pack_kernel(cuda, rows, n_parts, bucket, kind):
    """M1 bit for bit: buckets, sent-live flags and counts."""
    rng = np.random.default_rng(rows + n_parts)
    dest = rng.integers(0, n_parts, rows)
    if kind == "hot":
        dest[rng.random(rows) < 0.6] = 5
    elif kind == "one_dest":
        dest[:] = 3
    live = rng.random(rows) > 0.1
    if kind == "all_dead":
        live[:] = False
    elif kind == "late":
        # rows of the last 2048-row tile all go to 2, whose bucket holds
        # its earlier rows and 5 of those
        tail = rows // 2048 * 2048
        dest[tail:] = 2
        bucket = int((live[:tail] & (dest[:tail] == 2)).sum()) + 5
    payload = [
        torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, rows)),
        torch.from_numpy(rng.integers(0, 1 << 20, rows).astype(np.int32)),
        torch.from_numpy(rng.random(rows) > 0.5),
        torch.from_numpy(rng.integers(-100, 100, rows).astype(np.int8)),
        torch.from_numpy(rng.standard_normal(rows)),
    ]
    if kind == "limbs":
        payload.append(torch.from_numpy(rng.integers(0, 1 << 40, (rows, 2))))
    elif kind == "many_cols":
        payload = payload * 8
    d = torch.from_numpy(dest.astype(np.int32) if kind == "int32" else dest)
    lv = torch.from_numpy(live)
    want = K.partition_pack(d, lv, payload, n_parts, bucket)
    dev = [p.to(cuda) for p in payload]
    if kind == "dirty":
        # blocks of the buckets' sizes, filled with 0xFF and handed back to
        # the caching allocator, which gives them to the kernel's buckets
        junk = [torch.empty_like(w, device=cuda) for w in want[0]]
        junk.append(torch.empty_like(want[1], device=cuda))
        for j in junk:
            j.view(torch.uint8).fill_(0xFF)
        torch.cuda.synchronize()
        del junk
    K.partition_pack.launches = 0
    got = K.partition_pack(d.to(cuda), lv.to(cuda), dev, n_parts, bucket)
    torch.cuda.synchronize()
    assert K.partition_pack.launches == 1
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    if rows >= 100_000 or kind in _PACK_OVERFLOWS:
        assert bool((want[2] > bucket).any()) == (kind in _PACK_OVERFLOWS)


@pytest.mark.parametrize("rows,n_seg,dtype,op", [
    (0, 16, "int64", "sum"),
    (1_000_000, 16, "int64", "sum"),
    (1_000_000, 16, "float64", "sum"),
    (1_000_000, 300_000, "int64", "sum"),
    (1_000_000, 300_000, "float64", "sum"),
    (1_000_000, 16, "int64", "min"),
    (1_000_000, 300_000, "int64", "max"),
    (1_000_000, 16, "float64", "min"),
    (1_000_000, 16, "float64", "max"),
    (1_000_000, 300_000, "float64", "min"),
    (1_000_000, 8, "int64", "sum"),     # _dest_counts' histogram
])
def test_segment_reduce_kernel(cuda, rows, n_seg, dtype, op):
    """M2: int64 exact, float64 sums to relative 1e-12, float64 min/max
    exact with NaN, -0.0, empty slots and dropped ids."""
    rng = np.random.default_rng(rows + n_seg)
    group = rng.integers(-2, n_seg + 2, rows)
    group[(group >= 3) & (group < 5)] = 6  # empty slots
    if dtype == "int64":
        vals = rng.integers(-(1 << 62), 1 << 62, rows)
    else:
        vals = rng.standard_normal(rows) * 1e6
        vals[rng.random(rows) < 1e-4] = np.nan
        vals[rng.random(rows) < 0.05] = -0.0
        vals[rng.random(rows) < 0.05] = 0.0
        vals[group == 9] = -0.0
        vals[np.flatnonzero(group == 9)[::2]] = 0.0
    for ids in (np.int64, np.int32):
        v, g = torch.from_numpy(vals), torch.from_numpy(group.astype(ids))
        want = K.segment_reduce(v, g, n_seg, op)
        K.segment_reduce.launches = 0
        got = K.segment_reduce(v.to(cuda), g.to(cuda), n_seg, op).cpu()
        torch.cuda.synchronize()
        assert K.segment_reduce.launches == 1
        if dtype == "float64" and op == "sum":
            # as K2's float64 sums: the atomics add in another order
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-6,
                                       equal_nan=True)
        elif dtype == "float64":
            assert torch.equal(torch.isnan(got), torch.isnan(want))
            ok = ~torch.isnan(want)
            assert torch.equal(got[ok], want[ok])
            assert torch.equal(torch.signbit(got[ok]), torch.signbit(want[ok]))
        else:
            assert torch.equal(got, want)


def test_tiny_mesh_statements_on_card(cuda):
    """TPC-H statements on an 8-shard mesh of one card equal the CPU
    mesh's rows, with M1 and M2 launched."""
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.engine import QueryRunner
    from trino_tpu_torch.parallel import make_mesh

    card = QueryRunner.tpch("tiny", mesh=make_mesh(8))
    cpu = QueryRunner.tpch("tiny", mesh=make_mesh(8, device="cpu"))
    K.reset_launches()
    for q in ("q01", "q03", "q09", "q13", "q18", "q21"):
        got = card.execute(QUERIES[q]).rows
        want = cpu.execute(QUERIES[q]).rows
        assert sorted(map(repr, got)) == sorted(map(repr, want)), q
    assert K.partition_pack.launches > 0
    assert card.executor.exchange_stats["exchanges"] == cpu.executor.exchange_stats["exchanges"]
