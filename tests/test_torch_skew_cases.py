"""Adversarial inputs for the port's K4 ``expand_matches`` and A6
``quant_merge``.

``expand_case(name, seed)`` gives (order, lo, cnt, out_cap) and
``quant_case(name, seed)`` gives (states, eff, group, caps), as numpy
arrays (``group`` None for the global form). The CPU twins against the
JAX package (``test_torch_kernels.py``, ``test_torch_split.py``) and the
card tests (``test_torch_cuda.py``) import them, so the card and the CPU
see the same shapes. The tests here check that each case has the shape
its name promises.

K4 (tiles of 2048 probe rows; a row of more than 32 matches is written
by a grid of its own):

- ``empty``: no probe rows;
- ``no_matches``: every count 0;
- ``exact_cap``: counts 0-3, ``out_cap`` equal to the total;
- ``short_cap``: ``out_cap`` below the total, inside a 500-match row;
- ``tile_edges``: counts 0-40 and rows of 3000 matches on both sides of
  each tile boundary;
- ``hot_row``: counts 0 or 1 and one row holding most of ~305K outputs;
- ``wide_rows``: every seventh row wider than a tile (2049-4000).

A6 (k = 256 grouped, 1024 global; the kernel stages in shared memory
as many rows as 99% of the groups hold, up to what a block can have,
and a larger group reads its points from device memory):

- ``unsorted``: points in no order within their rows, many ties;
- ``zero_tie``: -0.0 and +0.0 (equal order bits) across rows of
  different weights, the target inside that tie;
- ``nan``: NaN, -inf and +inf points;
- ``none_eff``: no row contributes (every group answers ``has = false``);
- ``empty_groups``: only every third group id has rows;
- ``wide_group``: five groups of 12 rows among 600 of 2-3 (under 1% of
  the groups: they read from device memory);
- ``spread_sizes``: groups of 1 to 150 rows, staged for the largest but
  clamped to a block's shared memory (about 110 rows of 256 points on an
  H100), so that the largest read from device memory;
- ``global_wide6``, ``global_wide9``: the global form with 6 and 9 rows
  of 1024 points (staged past the default 48 KB of shared memory).
"""

import numpy as np
import pytest

from trino_tpu_torch.exec.kernels import EXPAND_HEAVY as K4_HEAVY
from trino_tpu_torch.exec.kernels import EXPAND_TILE as K4_TILE

EXPAND_CASES = ("empty", "no_matches", "exact_cap", "short_cap", "tile_edges",
                "hot_row", "wide_rows")
QUANT_CASES = ("unsorted", "zero_tie", "nan", "none_eff", "empty_groups",
               "wide_group", "spread_sizes", "global_wide6", "global_wide9")
#: rows of the spread_sizes case's groups
SPREAD_SIZES = (1, 3, 6, 7, 12, 13, 24, 25, 48, 49, 96, 97, 150)


def _ranges(rng, cnt, m):
    """lo for each row: inside [0, m - cnt] (any position for cnt 0)."""
    return (rng.random(cnt.size) * (m - cnt + 1)).astype(np.int64)


def expand_case(name, seed):
    """(order, lo, cnt, out_cap) of one K4 case."""
    rng = np.random.default_rng(seed)
    if name == "empty":
        n, m = 0, 64
        cnt = np.zeros(0, np.int64)
    elif name == "no_matches":
        n, m = 5000, 100
        cnt = np.zeros(n, np.int64)
    elif name in ("exact_cap", "short_cap"):
        n, m = 20_000, 4000
        cnt = rng.integers(0, 4, size=n).astype(np.int64)
        if name == "short_cap":
            cnt[n // 2] = 500
    elif name == "tile_edges":
        n, m = 3 * K4_TILE + 100, 6000
        cnt = rng.integers(0, 41, size=n).astype(np.int64)
        for t in (1, 2, 3):
            cnt[t * K4_TILE - 1] = cnt[t * K4_TILE] = 3000
    elif name == "hot_row":
        n, m = 50_000, 300_000
        cnt = (rng.random(n) < 0.5).astype(np.int64)
        cnt[20_011] = 280_000
    elif name == "wide_rows":
        n, m = 8000, 5000
        cnt = (rng.random(n) < 0.5).astype(np.int64)
        cnt[::7] = rng.integers(K4_TILE + 1, 4001, size=cnt[::7].size)
    else:
        raise ValueError(name)
    order = rng.permutation(m).astype(np.int64)
    lo = _ranges(rng, cnt, m)
    total = int(cnt.sum())
    if name == "exact_cap":
        out_cap = total
    elif name == "short_cap":
        out_cap = int(cnt[: n // 2].sum()) + 123
    else:
        out_cap = max(total, 1) + 37
    return order, lo, cnt, out_cap


def quant_case(name, seed):
    """(states, eff, group, caps) of one A6 case."""
    rng = np.random.default_rng(seed)
    k = 1024 if name.startswith("global") else 256
    rows = {"global_wide6": 6, "global_wide9": 9, "wide_group": 1560,
            "spread_sizes": 2 * sum(SPREAD_SIZES)}.get(name, 300)
    if name == "zero_tie":
        # per row: 80 negatives, 96 zeros of either sign, 80 positives
        neg = -rng.integers(1, 50, size=(rows, 80)) / 2.0
        zero = np.where(rng.random((rows, 96)) < 0.5, -0.0, 0.0)
        pos = rng.integers(1, 50, size=(rows, 80)) / 2.0
        pts = np.concatenate([neg, zero, pos], axis=1)
        pts = pts[:, rng.permutation(k)] if seed % 2 else pts
    else:
        pts = rng.integers(-40, 40, size=(rows, k)) / 4.0
        if name == "nan":
            pts[rng.random((rows, k)) < 0.05] = np.nan
            pts[rng.random((rows, k)) < 0.02] = -np.inf
            pts[rng.random((rows, k)) < 0.02] = np.inf
        if name != "unsorted":
            pts[rng.random((rows, k)) < 0.05] = -0.0
    if name not in ("unsorted", "zero_tie", "nan"):
        pts = np.sort(pts, axis=1)
    cnt = rng.integers(1, 5000, size=rows).astype(np.float64)
    cnt[::11] = 0.0
    states = np.concatenate([pts, cnt[:, None]], axis=1)
    eff = rng.random(rows) >= 0.1
    if name == "none_eff":
        eff[:] = False
    if name.startswith("global"):
        return states, eff, None, 1
    caps = 640 if name == "wide_group" else 64
    if name == "empty_groups":
        group = rng.integers(0, 20, size=rows) * 3
    elif name == "wide_group":
        # groups 0-4 hold 12 rows each, 5-604 two or three
        group = np.concatenate([np.repeat(np.arange(5), 12),
                                np.arange(rows - 60) % 600 + 5])
        group = group[rng.permutation(rows)]
    elif name == "spread_sizes":
        sizes = np.array(SPREAD_SIZES * 2)
        group = np.repeat(np.arange(sizes.size), sizes)[rng.permutation(rows)]
    else:
        group = rng.integers(0, 40, size=rows)
    return states, eff, group.astype(np.int64), caps


@pytest.mark.parametrize("name", EXPAND_CASES)
def test_expand_case_shape(name):
    order, lo, cnt, out_cap = expand_case(name, seed=3)
    m, n = order.size, cnt.size
    assert order.dtype == lo.dtype == cnt.dtype == np.int64
    assert np.array_equal(np.sort(order), np.arange(m))
    assert lo.shape == (n,) and (lo >= 0).all() and (lo + cnt <= m).all()
    total = int(cnt.sum())
    if name == "empty":
        assert n == 0
    elif name == "no_matches":
        assert total == 0
    elif name == "exact_cap":
        assert out_cap == total and cnt.max() <= K4_HEAVY
    elif name == "short_cap":
        start = int(cnt[: n // 2].sum())
        assert start < out_cap < start + cnt[n // 2] < total
    elif name == "tile_edges":
        assert (cnt[[K4_TILE - 1, K4_TILE]] > K4_TILE).all()
        assert ((cnt > K4_HEAVY) & (cnt <= 40)).any()
    elif name == "hot_row":
        assert cnt.max() > 0.8 * total and 300_000 < total < 400_000
    elif name == "wide_rows":
        assert (cnt > K4_TILE).sum() > 1000
    if name not in ("exact_cap", "short_cap"):
        assert out_cap > total


@pytest.mark.parametrize("name", QUANT_CASES)
def test_quant_case_shape(name):
    states, eff, group, caps = quant_case(name, seed=5)
    rows, k1 = states.shape
    k = k1 - 1
    pts, cnt = states[:, :k], states[:, k]
    assert k & (k - 1) == 0 and (cnt == np.round(cnt)).all()
    if group is None:
        assert caps == 1 and name.startswith("global")
        assert rows * k > 6144 if name == "global_wide9" else rows * k == 6144
        return
    assert group.min() >= 0 and group.max() < caps
    sizes = np.bincount(group, minlength=caps)
    if name == "unsorted":
        assert (np.diff(pts, axis=1) < 0).any(axis=1).all()
    elif name == "zero_tie":
        zeros = pts == 0.0
        assert (np.signbit(pts) & zeros).any() and (~np.signbit(pts) & zeros).any()
        assert len(np.unique(cnt)) > 10
    elif name == "nan":
        assert np.isnan(pts).any() and np.isinf(pts).any()
    elif name == "none_eff":
        assert not eff.any()
    elif name == "empty_groups":
        assert (sizes[1::3] == 0).all() and (sizes[::3] > 0).sum() >= 10
    elif name == "wide_group":
        assert (sizes[:5] == 12).all() and set(sizes[5:605]) == {2, 3}
        assert (sizes[605:] == 0).all()
    elif name == "spread_sizes":
        assert sorted(set(sizes[sizes > 0])) == list(SPREAD_SIZES)


@pytest.mark.parametrize("sizes,rows", [
    ([5] * 1000 + [2000], 5),         # one hot group: the rest stage
    ([16] * 300, 16),                 # every group staged
    ([2, 3] * 300 + [12] * 5, 3),     # under 1% of the groups read from HBM
    (list(range(1, 151)), 149),
    ([0, 7, 0], 7),                   # groups with no rows do not count
])
def test_quant_staged_rows(sizes, rows):
    """A6 stages as many rows as 99% of the groups with rows hold."""
    import torch

    from trino_tpu_torch.exec.kernels import _a6_staged_points

    counts = torch.tensor(sizes, dtype=torch.int64)
    assert _a6_staged_points(256, counts, int(counts.sum())) == rows * 256
    assert _a6_staged_points(1024, None, 9) == 9 * 1024
