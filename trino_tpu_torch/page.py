"""Device-resident columnar pages on torch tensors.

The port of ``trino_tpu/page.py``. A ``Page`` is a struct-of-arrays over
tensors on one device (the executor's):

- every column is one fixed-width tensor (``Column.data``); two-limb
  decimal(38) columns are ``[capacity, 2]``
- nulls are a separate bool validity tensor per column (None = all valid)
- a page-level bool ``mask`` marks live rows: filters clear mask bits and
  compaction happens only at host materialization or before joins
- VARCHAR columns carry a host-side sorted ``StringDictionary``; device
  data holds int32 codes

Every tensor is created with an explicit dtype taken from the SQL type's
numpy dtype (``torch_dtype``), so torch's float32 default never reaches a
SQL value. Capacities are padded to the same bucket family as the JAX
package, so shapes (and the aggregate overflow/retry decisions that
depend on them) match it exactly.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T

__all__ = [
    "StringDictionary", "HashStringPool", "HashCollision", "Column", "Page",
    "pad_capacity", "torch_dtype", "page_from_numpy", "unify_dictionaries",
    "content_hash64",
]

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype carrying a SQL type's numpy storage dtype."""
    return _TORCH_DTYPES[np.dtype(np_dtype)]


def content_hash64(strings: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit content hash of a string array, vectorized.

    Views the fixed-width UCS4 representation as uint32 lanes and folds
    them with an FNV-style polynomial, one vector op per character
    column. Unlike ``hash()`` (which PYTHONHASHSEED randomizes per
    process) the result is identical in every process, so HLL registers
    over the same values always agree."""
    arr = np.asarray(strings)
    if arr.dtype.kind != "U":
        arr = arr.astype(str)
    n = len(arr)
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    width = max(arr.dtype.itemsize // 4, 1)
    lanes = np.ascontiguousarray(arr).view(np.uint32).reshape(n, width)
    h = np.full(n, 0xCBF29CE484222325, dtype=np.uint64)
    prime = np.uint64(0x100000001B3)
    with np.errstate(over="ignore"):
        for j in range(width):
            lane = lanes[:, j].astype(np.uint64)
            # skip zero lanes (UCS4 tail padding): the hash must not
            # depend on the array's fixed width
            upd = (h ^ lane) * prime
            h = np.where(lane != 0, upd, h)
        # final avalanche so short strings spread over all 64 bits
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xFF51AFD7ED558CCD)
        h ^= h >> np.uint64(33)
    return h


def pad_capacity(n: int, minimum: int = 8) -> int:
    """Round up to a power of two or 1.5x a power of two (>= 96)."""
    c = max(int(n), minimum)
    p = 1 << (c - 1).bit_length()
    mid = (p // 4) * 3
    if mid >= max(c, 96):
        return mid
    return p


class StringDictionary:
    """Sorted, de-duplicated host-side string pool.

    Code order == lexicographic order, so <, >, ORDER BY and MIN/MAX on
    VARCHAR run entirely on device codes.
    """

    __slots__ = ("values", "derived")

    def __init__(self, values: np.ndarray):
        # values must be sorted & unique (callers use from_strings)
        self.values = values
        #: tables computed once from the values (the expression
        #: compiler's LIKE lookups and transform remaps), by key, least
        #: recently used first; the compiler bounds how many stay
        self.derived: OrderedDict = OrderedDict()

    @staticmethod
    def from_strings(strings: Sequence[str]) -> tuple["StringDictionary", np.ndarray]:
        """Build a dictionary and return (dict, int32 codes)."""
        arr = np.asarray(strings, dtype=object)
        uniq, codes = np.unique(arr.astype(str), return_inverse=True)
        return StringDictionary(uniq), codes.astype(np.int32)

    def __len__(self) -> int:
        return len(self.values)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return self.values[np.clip(codes, 0, len(self.values) - 1)]

    def union(self, other: "StringDictionary"):
        """(merged, remap_self, remap_other): int32 host arrays mapping
        old codes -> merged codes (applied on device with a gather)."""
        merged = np.union1d(self.values, other.values)
        remap_a = np.searchsorted(merged, self.values).astype(np.int32)
        remap_b = np.searchsorted(merged, other.values).astype(np.int32)
        return StringDictionary(merged), remap_a, remap_b


class HashCollision(RuntimeError):
    """Two distinct strings share a hash64 — astronomically rare; the
    caller rebuilds the column with a sorted dictionary."""

    def __init__(self, a, b):
        super().__init__(f"hash collision: {a!r} vs {b!r}")


_POOL_TOKENS = iter(range(1, 1 << 62))


class HashStringPool:
    """High-cardinality VARCHAR representation (SURVEY §7 hard-parts):
    the device column carries [hash64, source_row_id] lanes; this pool
    holds the HOST strings the id lane indexes, plus a one-time
    injectivity proof.

    Unlike sorted-dictionary codes, hash codes are GLOBALLY consistent
    (hash(s) is the same in every column), so joins/exchanges never
    remap — only the cross-pool injectivity check must pass. Building
    one costs a single hash pass instead of a sorted ``np.unique`` over
    every string.

    ``token`` is a process-unique id for cache keys (``id()`` can
    alias a freed pool's address; tokens never repeat).
    """

    __slots__ = (
        "values", "token", "_hashes", "_sorted", "_joinable", "derived",
    )

    def __init__(self, values: np.ndarray):
        self.values = values  # host object array, id lane indexes it
        self.token = next(_POOL_TOKENS)
        self._hashes: np.ndarray | None = None
        #: (unique sorted hashes, one representative string per hash)
        self._sorted: tuple[np.ndarray, np.ndarray] | None = None
        self._joinable: set[int] = set()
        #: tables computed once from the values (approx_distinct's
        #: content hashes), by key, as ``StringDictionary.derived``
        self.derived: OrderedDict = OrderedDict()

    def hashes(self) -> np.ndarray:
        if self._hashes is None:
            self._hashes = np.fromiter(
                (hash(s) for s in self.values),
                dtype=np.int64, count=len(self.values),
            )
        return self._hashes

    def verify_injective(self) -> None:
        """Prove hash64 is injective on this pool's values (memoized,
        vectorized: sort hashes, string-compare only within equal-hash
        runs — any run holding two distinct strings has an adjacent
        differing pair). A collision (probability ~n^2/2^64) raises —
        callers rebuild with a sorted dictionary."""
        if self._sorted is not None:
            return
        h = self.hashes()
        if len(h) == 0:
            self._sorted = (h, self.values)
            return
        order = np.argsort(h, kind="stable")
        hs = h[order]
        vs = self.values[order]
        same_h = hs[1:] == hs[:-1]
        if same_h.any():
            diff = same_h & (vs[1:] != vs[:-1])
            if diff.any():
                i = int(np.argmax(diff))
                raise HashCollision(vs[i], vs[i + 1])
        # dedupe to one representative per hash (injectivity proven)
        first = np.concatenate([[True], ~same_h])
        self._sorted = (hs[first], vs[first])

    def verify_joinable(self, other: "HashStringPool") -> None:
        """Prove injectivity across BOTH pools (join exactness);
        memoized per pool pair and fully vectorized: compare the
        representative strings at hash values common to both sides."""
        if other.token in self._joinable or other is self:
            return
        self.verify_injective()
        other.verify_injective()
        ha, va = self._sorted
        hb, vb = other._sorted
        common, ia, ib = np.intersect1d(
            ha, hb, assume_unique=True, return_indices=True
        )
        if len(common) and (va[ia] != vb[ib]).any():
            bad = int(np.argmax(va[ia] != vb[ib]))
            raise HashCollision(va[ia][bad], vb[ib][bad])
        self._joinable.add(other.token)
        other._joinable.add(self.token)


@dataclass
class Column:
    """One device column: fixed-width data + optional validity + dict.

    A hash-coded VARCHAR column (``hash_pool`` set) holds [cap, 2] int64
    data: the string's 64-bit hash and the row id into the pool's host
    strings."""

    type: T.DataType
    data: torch.Tensor
    valid: torch.Tensor | None = None  # None => all valid
    dictionary: StringDictionary | None = None
    hash_pool: HashStringPool | None = None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @staticmethod
    def from_numpy(
        type_: T.DataType,
        values: np.ndarray,
        valid: np.ndarray | None = None,
        capacity: int | None = None,
        dictionary: StringDictionary | None = None,
        device: torch.device | str = "cpu",
    ) -> "Column":
        if isinstance(type_, (T.ArrayType, T.MapType, T.RowType)):
            raise NotImplementedError(f"Column.from_numpy: {type_}")
        n = len(values)
        cap = capacity or pad_capacity(n)
        if type_.is_dictionary and dictionary is None:
            dictionary, values = StringDictionary.from_strings(values)
        arr = np.asarray(values)
        if arr.dtype != object and arr.ndim == 2:
            data = np.zeros((cap, arr.shape[1]), dtype=type_.np_dtype)
        else:
            data = np.zeros(cap, dtype=type_.np_dtype)
        data[:n] = np.asarray(values, dtype=type_.np_dtype)
        col_valid = None
        if valid is not None:
            v = np.zeros(cap, dtype=np.bool_)
            v[:n] = valid
            col_valid = torch.from_numpy(v).to(device)
        return Column(
            type_, torch.from_numpy(data).to(device), col_valid, dictionary
        )


@dataclass
class Page:
    """A batch of rows: named device columns + a live-row mask."""

    names: list[str]
    columns: list[Column]
    mask: torch.Tensor  # bool[capacity]; True = live row
    #: host-known live-row count (avoids a device sync when set)
    known_rows: int | None = None
    #: True when live rows occupy positions [0, known_rows) exactly
    packed: bool = False

    def __post_init__(self):
        if len(self.names) != len(self.columns):
            raise ValueError("names and columns differ in length")

    @property
    def capacity(self) -> int:
        return self.mask.shape[0]

    def column(self, name: str) -> Column:
        return self.columns[self.names.index(name)]

    def num_rows(self) -> int:
        """Live row count (device sync unless already host-known)."""
        if self.known_rows is not None:
            return self.known_rows
        return int(self.mask.sum())

    def to_pylist(self) -> list[tuple]:
        """Materialize live rows on host as python tuples. Packed pages
        with a host-known row count transfer only the live prefix."""
        k = self.known_rows if self.packed else None
        if k is not None:
            sel = np.arange(k)
            host = [
                (c.data[:k].cpu().numpy(),
                 None if c.valid is None else c.valid[:k].cpu().numpy())
                for c in self.columns
            ]
            sel_rows = slice(None)
        else:
            mask = self.mask.cpu().numpy()
            sel = np.nonzero(mask)[0]
            host = [
                (c.data.cpu().numpy(),
                 None if c.valid is None else c.valid.cpu().numpy())
                for c in self.columns
            ]
            sel_rows = sel
        cols = []
        for c, (data, valid) in zip(self.columns, host):
            data = data[sel_rows]
            valid = None if valid is None else valid[sel_rows]
            if c.dictionary is not None:
                data = c.dictionary.decode(data).astype(object)
            elif c.hash_pool is not None:
                data = c.hash_pool.values[data[:, 1]].astype(object)
            cols.append([
                None if (valid is not None and not valid[j])
                else _pyvalue(c.type, data[j])
                for j in range(len(sel))
            ])
        return [tuple(col[i] for col in cols) for i in range(len(sel))]


def _pyvalue(type_: T.DataType, v):
    if isinstance(type_, T.BooleanType):
        return bool(v)
    if isinstance(type_, T.DecimalType):
        import decimal

        if type_.is_long:
            # two-limb reconstruction in python ints: exact
            unscaled = int(v[0]) * (1 << 32) + int(v[1])
            return decimal.Decimal(unscaled).scaleb(-type_.scale)
        return decimal.Decimal(int(v)).scaleb(-type_.scale)
    if isinstance(type_, T.DateType):
        return T.format_date(int(v))
    if isinstance(type_, T.TimestampType):
        return T.format_timestamp(int(v))
    if isinstance(type_, (T.DoubleType, T.RealType)):
        return float(v)
    if isinstance(type_, (T.VarcharType,)):
        return str(v)
    if isinstance(type_, T.IntegerKind):
        return int(v)
    return v


def page_from_numpy(
    names: list[str],
    columns: list[tuple],
    mask: np.ndarray,
    device: torch.device | str = "cpu",
    known_rows: int | None = None,
    packed: bool = False,
) -> Page:
    """Build a port ``Page`` from a reference page's host arrays.

    ``columns`` holds one ``(type, data, valid, dictionary_values)``
    tuple per column: ``data`` the full-capacity storage array (codes for
    VARCHAR), ``valid`` a bool array or None, ``dictionary_values`` the
    sorted dictionary strings or None. Arrays are copied as they are, so
    both packages see bit-identical inputs."""
    cols = []
    for type_, data, valid, dict_values in columns:
        arr = np.ascontiguousarray(np.asarray(data, dtype=type_.np_dtype))
        v = None
        if valid is not None:
            v = torch.from_numpy(
                np.ascontiguousarray(np.asarray(valid, dtype=np.bool_))
            ).to(device)
        d = None
        if dict_values is not None:
            d = StringDictionary(np.asarray(dict_values))
        cols.append(Column(type_, torch.from_numpy(arr).to(device), v, d))
    m = torch.from_numpy(
        np.ascontiguousarray(np.asarray(mask, dtype=np.bool_))
    ).to(device)
    return Page(list(names), cols, m, known_rows=known_rows, packed=packed)


def unify_dictionaries(a: Column, b: Column) -> tuple[Column, Column]:
    """Remap two VARCHAR columns onto one shared sorted dictionary.

    Host computes the merged dictionary; the code remap itself is a
    device-side gather."""
    if a.dictionary is None or b.dictionary is None:
        raise ValueError("both columns must be dictionary-encoded")
    if a.dictionary is b.dictionary:
        return a, b
    merged, ra, rb = a.dictionary.union(b.dictionary)
    return _remap(a, ra, merged), _remap(b, rb, merged)


def _remap(col: Column, remap: np.ndarray, merged: StringDictionary) -> Column:
    if len(remap) == 0:
        # empty dictionary: no live codes exist; keep data as-is
        return replace(col, dictionary=merged)
    table = torch.from_numpy(remap).to(col.data.device)
    codes = col.data.long().clamp(0, len(remap) - 1)
    return replace(col, data=table[codes], dictionary=merged)
