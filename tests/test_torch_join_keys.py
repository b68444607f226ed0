"""Adversarial join-key sets for the port's K3 ``join_probe``.

``join_key_set(name, m, n, seed)`` gives (build_key, build_live,
probe_key, probe_live) as numpy arrays, the keys int64 carrying u64
bits. The CPU twins against the JAX package (``test_torch_kernels.py``)
and the card tests (``test_torch_cuda.py``) both import it, so the card
and the CPU see the same shapes. The tests here check that each set has
the shape its name promises.

- ``outlier``: one build key at 2^62 above a dense range of order keys
  (the key-range directory degenerates: the dense range shares one
  bucket);
- ``hot``: one build key holding 30% of the build rows;
- ``hashed``: uniform u64 keys, bit 63 set on about half of them (what
  multi-column keys look like after ``hash_keys``);
- ``outside``: every probe key below the least live build key or above
  the greatest, in unsigned order;
- ``one_live``: a single live build row;
- ``sorted``: probes in key order, each build key repeated 1-7 times, as
  lineitem gives its order keys.
"""

import numpy as np
import pytest

KEY_SETS = ("outlier", "hot", "hashed", "outside", "one_live", "sorted")
OUTLIER = 1 << 62
HOT_SHARE = 0.3
HOT_PROBES = 40
#: the dense keys start at OFFSET in the ``outside`` set
OFFSET = 1 << 40


def _mixed_probes(rng, keys, n, hi):
    """Half of the probes from ``keys``, a quarter one past a key (mostly
    misses), a quarter anywhere in [0, hi)."""
    pk = keys[rng.integers(0, keys.size, size=n)]
    near = rng.random(n)
    pk = np.where(near < 0.25, pk + 1, pk)
    anywhere = rng.integers(0, hi, size=n, dtype=np.int64)
    return np.where(near >= 0.75, anywhere, pk).astype(np.int64)


def join_key_set(name, m, n, seed):
    """(build_key, build_live, probe_key, probe_live) of one key set."""
    rng = np.random.default_rng(seed)
    dense = np.arange(m, dtype=np.int64) * 4 + 1  # sparse order keys
    build_live = rng.random(m) >= 0.2
    probe_live = rng.random(n) >= 0.2
    if name == "outlier":
        bk = dense.copy()
        at = int(rng.integers(0, m))
        bk[at] = OUTLIER
        build_live[at] = True
        pk = _mixed_probes(rng, bk, n, 4 * m + 8)
        pk[: min(n, 3)] = [OUTLIER, OUTLIER + 1, OUTLIER - 1][: min(n, 3)]
    elif name == "hot":
        bk = dense.copy()
        bk[rng.random(m) < HOT_SHARE] = dense[m // 2]
        # uniform over the range, plus HOT_PROBES probes of the hot key
        # (each matches 30% of the build side)
        pk = rng.integers(0, 4 * m + 8, size=n, dtype=np.int64)
        pk[rng.choice(n, size=min(HOT_PROBES, n), replace=False)] = dense[m // 2]
    elif name == "hashed":
        bk = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                          size=m, dtype=np.int64, endpoint=True)
        pk = np.where(
            rng.random(n) < 0.5, bk[rng.integers(0, m, size=n)],
            rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                         size=n, dtype=np.int64, endpoint=True),
        )
    elif name == "outside":
        bk = dense + OFFSET
        below = rng.integers(0, OFFSET, size=n, dtype=np.int64)
        # above in unsigned order: past the range, or bit 63 set
        above = np.where(
            rng.random(n) < 0.5,
            rng.integers(OFFSET + 4 * m, 1 << 62, size=n, dtype=np.int64),
            rng.integers(np.iinfo(np.int64).min, 0, size=n, dtype=np.int64),
        )
        pk = np.where(rng.random(n) < 0.5, below, above)
    elif name == "one_live":
        bk = dense.copy()
        build_live[:] = False
        at = int(rng.integers(0, m))
        build_live[at] = True
        pk = _mixed_probes(rng, bk, n, 4 * m + 8)
        pk[rng.integers(0, n, size=max(n // 100, 1))] = bk[at]
    elif name == "sorted":
        bk = dense.copy()
        pk = np.repeat(dense, rng.integers(1, 8, size=m))[:n]
        pk = np.sort(_mixed_probes(rng, pk, n, 4 * m + 8))
    else:
        raise ValueError(name)
    order = rng.permutation(m)
    return bk[order], build_live[order], pk, probe_live


def _unsigned(x):
    return x.view(np.uint64)


@pytest.mark.parametrize("name", KEY_SETS)
def test_join_key_set_shape(name):
    m, n = 4000, 6000
    bk, bl, pk, pl = join_key_set(name, m, n, seed=11)
    assert bk.shape == bl.shape == (m,) and pk.shape == pl.shape == (n,)
    assert bk.dtype == pk.dtype == np.int64
    live = _unsigned(bk[bl])
    if name == "outlier":
        assert live.max() == OUTLIER and np.sort(live)[-2] < 4 * m
        assert (pk == OUTLIER).any()
    elif name == "hot":
        values, counts = np.unique(bk, return_counts=True)
        assert abs(counts.max() / m - HOT_SHARE) < 0.03
        assert (pk == values[counts.argmax()]).sum() >= HOT_PROBES
    elif name == "hashed":
        assert 0.4 < (bk < 0).mean() < 0.6 and 0.4 < (pk < 0).mean() < 0.6
    elif name == "outside":
        p = _unsigned(pk)
        assert ((p < live.min()) | (p > live.max())).all()
        assert (p < live.min()).any() and (pk < 0).any()
    elif name == "one_live":
        assert bl.sum() == 1 and (pk == bk[bl][0]).sum() >= n // 200
    elif name == "sorted":
        assert (np.diff(pk) >= 0).all() and np.isin(pk, bk).mean() > 0.4
