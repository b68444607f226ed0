"""Inputs around the tiles of the port's A3 ``seg_arg_extreme`` and W1
``window_peers``.

``arg_case(name, n, seed, live_rows)`` gives (gkey, live, contrib, keys) and
``peer_case(name, n, seed)`` gives (gid, pend, perm, keys), as numpy
arrays; W1's keys are (data, valid or None) pairs in original row order,
and its rows are sorted by partition with the dead rows last under one
id past the live ones. The CPU twins against the JAX package
(``test_torch_aggregates.py``, ``test_torch_window.py``) take them at a
small ``n``, the card tests (``test_torch_cuda.py``) at sizes of many
tiles, so the card and the CPU see the same shapes. The tests here check
that each case has the shape its name promises.

Both kernels take sorted positions in tiles of 2048 (``ARG_TILE``,
``PEERS_TILE``). A3's cases (its tiles run over the live rows):

- ``edge``: groups of ~16 rows and exactly ``live_rows`` live rows: at a
  multiple of 2048 or one row either side, the last tile is full, one
  short or one row long;
- ``long_group``: three groups over every row (float64 keys with NaN,
  -0.0 and ties), each over many tiles at the card's sizes;
- ``singletons``: a group a live row (``live_rows`` of them, or every
  row), so every group starts and ends in its tile;
- ``dead_run``: two fifths of the groups, a run of sorted positions
  longer than a tile, have no contributing row;
- ``none``: no row contributes.

W1's cases:

- ``edge``: partitions of 1-39 rows and a nullable int64 key of 4 values;
- ``long``: three partitions ordered by a key of 3 values, so peer
  groups of about n / 9 rows;
- ``one_group``: one partition and no key part: one peer group over
  every row;
- ``unique``: one partition and distinct keys: every row a boundary;
- ``keys32``: 32 key parts of int64, int32, float64 (0.0 beside -0.0)
  and bool, some nullable with other data under their NULLs, over
  partitions of 1-39 rows.
"""

import numpy as np
import pytest

from trino_tpu_torch.exec.kernels import ARG_TILE, MAX_KEY_PARTS, PEERS_TILE

ARG_CASES = ("edge", "long_group", "singletons", "dead_run", "none")
PEER_CASES = ("edge", "long", "one_group", "unique", "keys32")


def arg_case(name: str, n: int, seed: int, live_rows: int | None = None):
    rng = np.random.default_rng(seed)
    live = np.ones(n, dtype=bool)
    if live_rows is not None:
        live[:] = False
        live[rng.permutation(n)[:live_rows]] = True
    if name == "edge":
        gkey = rng.integers(0, max(n // 16, 1), size=n)
    elif name == "singletons":
        gkey = rng.permutation(n)
    else:
        gkey = rng.integers(0, 3 if name == "long_group" else 40, size=n)
        if live_rows is None:
            live = rng.random(n) >= 0.1
    contrib = live & (rng.random(n) >= 0.3)
    if name == "dead_run":
        contrib &= gkey >= 16
    elif name == "none":
        contrib[:] = False
    if name == "long_group":
        keys = rng.integers(-4, 4, size=n).astype(np.float64)
        keys[::29] = np.nan
        keys[1::13] = -0.0
        keys[2::13] = 0.0
    else:
        keys = rng.integers(-3, 3, size=n).astype(np.int64)
        keys[::11] = np.iinfo(np.int64).max  # the would-be sentinels
        keys[1::11] = np.iinfo(np.int64).min
    return gkey.astype(np.int64), live, contrib, keys


def _partitions(rng, n: int, name: str):
    """Sorted partition ids of n rows, 10% dead rows last under id n."""
    n_live = int(n * 0.9)
    if name in ("edge", "keys32"):
        gid = np.repeat(np.arange(n), rng.integers(1, 40, size=n))[:n_live]
    elif name == "long":
        gid = np.sort(rng.integers(0, 3, size=n_live))
    else:
        gid = np.zeros(n_live, dtype=np.int64)
    return np.concatenate([gid, np.full(n - n_live, n)]).astype(np.int64)


def _pend(gid):
    n = gid.shape[0]
    if n == 0:
        return gid.copy()
    pos = np.arange(n)
    last = np.r_[gid[1:] != gid[:-1], True]
    return np.minimum.accumulate(np.where(last, pos + 1, n + 1)[::-1])[::-1]


def peer_case(name: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    gid = _partitions(rng, n, name)
    perm = rng.permutation(n).astype(np.int64)
    # each sorted row's key value, non-decreasing inside a partition
    levels = {"edge": 4, "long": 3, "unique": n, "keys32": 8}.get(name, 1)
    if name == "unique":
        v = np.arange(n, dtype=np.int64)
    else:
        v = np.sort(gid * levels + rng.integers(0, levels, size=n)) - gid * levels

    def original(sorted_values):
        out = np.empty_like(sorted_values)
        out[perm] = sorted_values
        return out

    keys = []
    if name in ("edge", "long", "unique"):
        valid = None
        if name == "edge":
            valid = original(v != 3)
        keys = [(original(v), valid)]
    elif name == "keys32":
        for j in range(MAX_KEY_PARTS):
            bit = (v >> (j % 3)) & 1
            kind = j % 4
            if kind == 0:
                data = bit.astype(np.int64)
            elif kind == 1:
                data = (bit * 7 - 3).astype(np.int32)
            elif kind == 2:
                data = np.where(bit == 1, 2.5, np.where(rng.random(n) < 0.5, -0.0, 0.0))
            else:
                data = bit.astype(bool)
            valid = None
            if j % 5 == 0:
                null = v == 7
                valid = ~null
                if kind != 3:  # other data under the NULLs
                    data = np.where(null, data + 1, data).astype(data.dtype)
            keys.append((original(data), None if valid is None else original(valid)))
    return gid, _pend(gid).astype(np.int64), perm, keys


def _groups_of(gkey, live):
    _, sizes = np.unique(gkey[live], return_counts=True)
    return sizes


def test_arg_case_shapes():
    n = 4 * ARG_TILE
    gkey, live, contrib, _ = arg_case("edge", n + 100, 1, live_rows=n)
    assert live.sum() == n and _groups_of(gkey, live).max() < ARG_TILE
    gkey, live, _, _ = arg_case("singletons", n, 3, live_rows=1000)
    assert live.sum() == 1000 and (_groups_of(gkey, live) == 1).all()
    gkey, live, contrib, keys = arg_case("long_group", n, 2)
    assert (_groups_of(gkey, live) > ARG_TILE).all() and np.isnan(keys).any()
    gkey, live, _, _ = arg_case("singletons", n, 3)
    assert (_groups_of(gkey, live) == 1).all()
    gkey, live, contrib, _ = arg_case("dead_run", n, 4)
    dead = live & (gkey < 16)
    assert dead.sum() > ARG_TILE and not contrib[dead].any() and contrib.any()
    _, _, contrib, _ = arg_case("none", n, 5)
    assert not contrib.any()


@pytest.mark.parametrize("name", PEER_CASES)
def test_peer_case_shapes(name):
    n = 4 * PEERS_TILE + 1
    gid, pend, perm, keys = peer_case(name, n, 7)
    assert (np.diff(gid) >= 0).all() and np.array_equal(np.sort(perm), np.arange(n))
    pos = np.arange(n)
    assert (pend > pos).all() and (pend <= n).all()
    # sorted boundaries: a partition change or any key part's change
    b = np.r_[True, gid[1:] != gid[:-1]]
    for data, valid in keys:
        s = data[perm]
        nul = np.zeros(n, bool) if valid is None else ~valid[perm]
        s = np.where(nul, 0, s)
        if s.dtype.kind == "f":
            s = s + 0.0  # -0.0 -> 0.0
        b[1:] |= (s[1:] != s[:-1]) | (nul[1:] != nul[:-1])
    runs = np.diff(np.flatnonzero(np.r_[b, True]))
    if name == "long":
        assert runs.max() > n // 12
    elif name == "one_group":
        assert not keys and runs.max() >= int(n * 0.9)
    elif name == "unique":
        assert b.all()
    elif name == "keys32":
        live_runs = np.diff(np.flatnonzero(np.r_[b[: int(n * 0.9)], True]))
        assert len(keys) == MAX_KEY_PARTS and 1 < live_runs.max() < 40
