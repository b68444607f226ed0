"""Expression -> column-function compiler on torch tensors.

The port of ``trino_tpu/expr/compiler.py`` for the subset that TPC-H Q1
and Q3 (and statements like them) need: integer, double and decimal
arithmetic (``_arith``, ``_decimal_arith``, ``_div_round_half_up``),
comparisons including two-limb and mixed-scale decimals, Kleene logic,
IN, IF/CASE, COALESCE, casts, date literals and the civil-date helpers,
and dictionary-coded VARCHAR comparisons. Anything else raises
``NotImplementedError`` naming the function.

Null semantics: every evaluation returns ``(data, valid)`` where
``valid`` is a bool tensor or None (all valid). Constants are 0-dim
tensors on the layout's device, created with the SQL type's dtype.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.expr.ir import Call, Cast, InputRef, Literal, RowExpression
from trino_tpu_torch.page import StringDictionary, torch_dtype

__all__ = ["ColumnLayout", "CompiledExpr", "compile_expr"]

I64 = torch.int64

# evaluation environment: name -> (data, valid|None)
Env = dict[str, tuple[torch.Tensor, torch.Tensor | None]]


@dataclass
class ColumnLayout:
    """Input layout a compilation binds to: types, dictionaries and the
    device its constants live on."""

    types: dict[str, T.DataType] = field(default_factory=dict)
    dictionaries: dict[str, StringDictionary | None] = field(default_factory=dict)
    device: torch.device | str = "cpu"


@dataclass
class CompiledExpr:
    fn: Callable[[Env], tuple[torch.Tensor, torch.Tensor | None]]
    type: T.DataType
    dictionary: StringDictionary | None = None  # set when type is varchar
    is_literal: bool = False


def compile_expr(expr: RowExpression, layout: ColumnLayout) -> CompiledExpr:
    return _Compiler(layout).compile(expr)


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


class _Compiler:
    def __init__(self, layout: ColumnLayout):
        self.layout = layout
        self.device = torch.device(layout.device)

    def _const(self, value, np_dtype) -> torch.Tensor:
        return torch.tensor(value, dtype=torch_dtype(np_dtype), device=self.device)

    def compile(self, expr: RowExpression) -> CompiledExpr:
        if isinstance(expr, Literal):
            return self._literal(expr)
        if isinstance(expr, InputRef):
            name = expr.name
            return CompiledExpr(
                lambda env: env[name],
                expr.type,
                self.layout.dictionaries.get(name),
            )
        if isinstance(expr, Cast):
            return self._cast(expr)
        if isinstance(expr, Call):
            return self._call(expr)
        raise NotImplementedError(f"cannot compile {expr!r}")

    # ---- literals --------------------------------------------------------
    def _literal(self, expr: Literal) -> CompiledExpr:
        if isinstance(expr.type, (T.ArrayType, T.MapType, T.RowType)):
            raise NotImplementedError(f"_literal: {expr.type}")
        if expr.value is None:
            data = self._const(0, expr.type.np_dtype)
            valid = torch.zeros((), dtype=torch.bool, device=self.device)
            return CompiledExpr(
                lambda env: (data, valid), expr.type, is_literal=True,
            )
        if isinstance(expr.type, T.VarcharType):
            d = StringDictionary(np.asarray([str(expr.value)]))
            code = torch.zeros((), dtype=torch.int32, device=self.device)
            return CompiledExpr(
                lambda env: (code, None), expr.type, d, is_literal=True,
            )
        value = self._const(_literal_device_value(expr), expr.type.np_dtype)
        return CompiledExpr(
            lambda env: (value, None), expr.type, is_literal=True,
        )

    # ---- casts -----------------------------------------------------------
    def _cast(self, expr: Cast) -> CompiledExpr:
        src = self.compile(expr.arg)
        s_t, d_t = src.type, expr.type
        if s_t == d_t:
            return src

        def wrap(f):
            def ev(env):
                data, valid = src.fn(env)
                return f(data), valid

            return CompiledExpr(ev, d_t, is_literal=src.is_literal)

        if isinstance(d_t, (T.DoubleType, T.RealType)):
            dtype = torch_dtype(d_t.np_dtype)
            if isinstance(s_t, T.DecimalType) and s_t.is_long:
                scale = 10.0 ** s_t.scale
                return wrap(
                    lambda x: (
                        x[..., 0].to(torch.float64) * 4294967296.0
                        + x[..., 1].to(torch.float64)
                    ).to(dtype) / scale
                )
            if isinstance(s_t, T.DecimalType):
                scale = 10.0 ** s_t.scale
                return wrap(lambda x: x.to(dtype) / scale)
            return wrap(lambda x: x.to(dtype))
        if isinstance(d_t, T.DecimalType):
            if (isinstance(s_t, T.DecimalType) and s_t.is_long) or (
                isinstance(s_t, T.DecimalType) and d_t.is_long
            ):
                return self._limb_rescale_cast(src, s_t, d_t)
            if d_t.is_long and s_t.is_integer:
                from trino_tpu_torch.exec.aggregates import _limb_encode

                m = 10 ** d_t.scale
                return wrap(lambda x: _limb_encode(x.to(I64) * m))
            if d_t.is_long and isinstance(s_t, (T.DoubleType, T.RealType)):
                m = 10.0 ** d_t.scale

                def ev_f2l(env, _m=m):
                    x, v = src.fn(env)
                    y = torch.sign(x) * torch.floor(torch.abs(x) * _m + 0.5)
                    hi = torch.floor(y / 4294967296.0)
                    lo = (y - hi * 4294967296.0).to(I64)
                    return torch.stack([hi.to(I64), lo], dim=-1), v

                return CompiledExpr(ev_f2l, d_t, is_literal=src.is_literal)
            if d_t.is_long:
                raise NotImplementedError(f"cast {s_t} -> {d_t}")
            if isinstance(s_t, T.DecimalType):
                if d_t.scale >= s_t.scale:
                    m = 10 ** (d_t.scale - s_t.scale)
                    return wrap(lambda x: x * m)
                m = 10 ** (s_t.scale - d_t.scale)
                return wrap(lambda x: _div_round_half_up(x, m))
            if s_t.is_integer:
                m = 10 ** d_t.scale
                return wrap(lambda x: x.to(I64) * m)
            if isinstance(s_t, (T.DoubleType, T.RealType)):
                m = 10.0 ** d_t.scale
                return wrap(
                    lambda x: (
                        torch.sign(x) * torch.floor(torch.abs(x) * m + 0.5)
                    ).to(I64)
                )
        if d_t.is_integer:
            dtype = torch_dtype(d_t.np_dtype)
            if isinstance(s_t, T.DecimalType):
                m = 10 ** s_t.scale
                return wrap(lambda x: _div_round_half_up(x, m).to(dtype))
            if isinstance(s_t, (T.DoubleType, T.RealType)):
                return wrap(lambda x: torch.floor(x + 0.5).to(dtype))
            return wrap(lambda x: x.to(dtype))
        if isinstance(d_t, T.DateType) and isinstance(s_t, T.VarcharType):
            return self._varchar_to_date(src)
        if isinstance(d_t, T.DateType) and isinstance(s_t, T.TimestampType):
            return wrap(
                lambda x: torch.div(
                    x, T.MICROS_PER_DAY, rounding_mode="floor"
                ).to(torch.int32)
            )
        if isinstance(d_t, T.TimestampType) and isinstance(s_t, T.DateType):
            return wrap(lambda x: x.to(I64) * T.MICROS_PER_DAY)
        raise NotImplementedError(f"_cast: {s_t} -> {d_t}")

    def _varchar_to_date(self, src: CompiledExpr) -> CompiledExpr:
        """cast(varchar as date): the dictionary parsed once on the host,
        then a gather by code on the device; unparseable values become
        NULL (port of the JAX compiler's varchar -> date cast)."""
        if src.dictionary is None:
            raise NotImplementedError(
                "cast varchar -> date requires a dictionary input"
            )
        vals, bad = [], []
        for v in src.dictionary.values:
            try:
                vals.append(T.parse_date(str(v)))
                bad.append(False)
            except (ValueError, TypeError):
                vals.append(0)
                bad.append(True)
        n = max(len(vals), 1)
        table = torch.from_numpy(
            np.asarray(vals + [0] * (n - len(vals)), dtype=np.int32)
        ).to(self.device)
        badt = torch.from_numpy(
            np.asarray(bad + [True] * (n - len(bad)), dtype=np.bool_)
        ).to(self.device)
        has_bad = any(bad)

        def ev(env):
            data, valid = src.fn(env)
            code = data.long().clamp(0, n - 1)
            out = table[code]
            if has_bad:
                okv = ~badt[code]
                valid = okv if valid is None else (valid & okv)
            return out, valid

        return CompiledExpr(ev, T.DATE, is_literal=src.is_literal)

    def _limb_rescale_cast(
        self, src: CompiledExpr, s_t: "T.DecimalType", d_t: "T.DecimalType"
    ) -> CompiledExpr:
        """Exact decimal rescale where either side is a two-limb
        decimal(>18)."""
        from trino_tpu_torch.exec.aggregates import (
            _limb_div_round,
            _limb_encode,
            _limb_norm,
        )

        diff = d_t.scale - s_t.scale
        if 10 ** abs(diff) > 2**31:
            raise NotImplementedError(
                f"cast {s_t} -> {d_t}: rescale by >10^9"
            )
        s_long = s_t.is_long

        def ev(env):
            x, v = src.fn(env)
            if s_long:
                hi, lo = x[..., 0], x[..., 1]
            else:
                xi = x.to(I64)
                hi, lo = xi >> 32, xi & 0xFFFFFFFF
            if diff > 0:
                m = 10 ** diff
                hi, lo = _limb_norm(hi * m, lo * m)
            elif diff < 0:
                q = _limb_div_round(
                    hi, lo, torch.tensor(10 ** (-diff), dtype=I64, device=hi.device)
                )
                if d_t.is_long:
                    return _limb_encode(q), v
                return q, v
            if d_t.is_long:
                return torch.stack([hi, lo], dim=-1), v
            return hi * 4294967296 + lo, v

        return CompiledExpr(ev, d_t, is_literal=src.is_literal)

    # ---- calls -----------------------------------------------------------
    def _call(self, expr: Call) -> CompiledExpr:
        name = expr.name
        if name in ("and", "or"):
            return self._logic(expr)
        if name == "not":
            a = self.compile(expr.args[0])
            return CompiledExpr(
                lambda env: (lambda d, v: (~d, v))(*a.fn(env)), T.BOOLEAN
            )
        if name == "is_null":
            a = self.compile(expr.args[0])

            def ev_isnull(env):
                data, valid = a.fn(env)
                if valid is None:
                    return torch.zeros(
                        data.shape[:1], dtype=torch.bool, device=data.device
                    ), None
                return ~valid, None

            return CompiledExpr(ev_isnull, T.BOOLEAN)
        if name == "if":
            return self._if(expr)
        if name == "coalesce":
            return self._coalesce(expr)
        if name == "in":
            return self._in(expr)
        if name in _STRING_PREDICATES:
            return self._string_predicate(expr)
        if name in _STRING_TRANSFORMS:
            return self._string_transform(expr)
        if name in ("eq", "ne", "lt", "le", "gt", "ge"):
            return self._comparison(expr)
        if name in ("add", "subtract", "multiply", "divide", "modulus"):
            return self._arith(expr)
        if name == "negate":
            a = self.compile(expr.args[0])
            return CompiledExpr(
                lambda env: (lambda d, v: (-d, v))(*a.fn(env)), expr.type
            )
        if name == "nullif":
            # args: (a, a = b): NULL where the comparison is TRUE (an
            # unknown comparison keeps a)
            a = self.compile(expr.args[0])
            cond = self.compile(expr.args[1])

            def ev_nullif(env):
                d, v = a.fn(env)
                cd, cv = cond.fn(env)
                nullify = cd if cv is None else (cd & cv)
                nv = ~nullify if v is None else (v & ~nullify)
                return d, nv

            return CompiledExpr(ev_nullif, expr.type, a.dictionary)
        if name == "concat_cols":
            return self._concat_cols(expr)
        if name == "round":
            return self._round(expr)
        if name in _SIMPLE_FNS:
            return self._simple(expr)
        raise NotImplementedError(f"function {name} not implemented")

    def _concat_cols(self, expr: Call) -> CompiledExpr:
        """varchar || varchar between two dictionary-backed columns: the
        result dictionary is the (bounded) cross product of the operand
        dictionaries; the device op is one gather by the composite code
        a * |B| + b."""
        a = self.compile(expr.args[0])
        b = self.compile(expr.args[1])
        da, db = a.dictionary, b.dictionary
        if da is None or db is None:
            raise NotImplementedError(
                "|| requires dictionary-backed varchar operands"
            )
        na, nb = max(len(da), 1), max(len(db), 1)
        if na * nb > 4_000_000:
            raise NotImplementedError(
                f"|| dictionary product too large ({na}x{nb})"
            )
        pairs = np.asarray(
            [str(x) + str(y) for x in da.values for y in db.values] or [""],
            dtype=object,
        )
        new_dict, codes = StringDictionary.from_strings(pairs)
        remap = torch.from_numpy(codes.astype(np.int32)).to(self.device)

        def ev(env):
            ad, av = a.fn(env)
            bd, bv = b.fn(env)
            code = (ad.long() * nb + bd.long()).clamp(0, na * nb - 1)
            return remap[code], _and_valid(av, bv)

        return CompiledExpr(ev, T.VARCHAR, new_dict)

    def _round(self, expr: Call) -> CompiledExpr:
        """round(x[, n]): half away from zero (not banker's rounding).
        Decimal inputs round on the unscaled integer; the digit count
        must be a constant."""
        a = self.compile(expr.args[0])
        ndig = 0
        if len(expr.args) > 1:
            d = expr.args[1]
            if not isinstance(d, Literal) or d.value is None:
                raise NotImplementedError(
                    "round() digit count must be a constant"
                )
            ndig = int(d.value)
        out_t = expr.type

        def ev(env):
            x, v = a.fn(env)
            if isinstance(a.type, T.DecimalType):
                if a.type.is_long:
                    raise NotImplementedError("round() of a decimal(38)")
                s = a.type.scale
                if ndig >= s:
                    return x, v
                m = 10 ** (s - ndig)
                return _div_round_half_up(x, m) * m, v
            if a.type.is_integer:
                return x, v
            scale = 10.0 ** ndig
            y = x * scale
            return (
                (torch.sign(y) * torch.floor(torch.abs(y) + 0.5) / scale)
                .to(torch_dtype(out_t.np_dtype)),
                v,
            )

        return CompiledExpr(ev, out_t)

    def _logic(self, expr: Call) -> CompiledExpr:
        parts = [self.compile(a) for a in expr.args]
        is_and = expr.name == "and"

        def ev(env):
            datas, valids = zip(*(p.fn(env) for p in parts))
            # Kleene: fill nulls with the identity, track "known" rows
            ident = is_and
            filled = [
                d if v is None else torch.where(v, d, ident)
                for d, v in zip(datas, valids)
            ]
            out = filled[0]
            for f in filled[1:]:
                out = (out & f) if is_and else (out | f)
            if all(v is None for v in valids):
                return out, None
            known = None
            for v in valids:
                known = _and_valid(known, v)
            decided = out != ident  # AND: any false decides; OR: any true
            return out, known | decided

        return CompiledExpr(ev, T.BOOLEAN)

    def _if(self, expr: Call) -> CompiledExpr:
        cond, then, els = (self.compile(a) for a in expr.args)
        out_dict = _merge_result_dicts(expr.type, [then, els])
        redict_then = _redict_fn(then, out_dict, self.device)
        redict_els = _redict_fn(els, out_dict, self.device)

        def ev(env):
            c_d, c_v = cond.fn(env)
            t_d, t_v = then.fn(env)
            e_d, e_v = els.fn(env)
            take_then = c_d if c_v is None else (c_d & c_v)
            data = torch.where(
                _lanes(take_then, t_d), redict_then(t_d), redict_els(e_d)
            )
            if t_v is None and e_v is None:
                return data, None
            t_vv = t_v if t_v is not None else torch.ones_like(take_then)
            e_vv = e_v if e_v is not None else torch.ones_like(take_then)
            return data, torch.where(take_then, t_vv, e_vv)

        return CompiledExpr(ev, expr.type, out_dict)

    def _coalesce(self, expr: Call) -> CompiledExpr:
        parts = [self.compile(a) for a in expr.args]
        out_dict = _merge_result_dicts(expr.type, parts)
        redicts = [_redict_fn(p, out_dict, self.device) for p in parts]

        def ev(env):
            data, valid = parts[0].fn(env)
            data = redicts[0](data)
            for p, rd in zip(parts[1:], redicts[1:]):
                if valid is None:
                    break
                d, v = p.fn(env)
                data = torch.where(_lanes(valid, data), data, rd(d))
                valid = valid | (v if v is not None else True)
            return data, valid

        return CompiledExpr(ev, expr.type, out_dict)

    def _in(self, expr: Call) -> CompiledExpr:
        value = expr.args[0]
        items = expr.args[1:]
        a = self.compile(value)
        if isinstance(value.type, T.VarcharType):
            # IN over literal strings -> dictionary LUT
            dict_ = a.dictionary
            if dict_ is None or not all(isinstance(i, Literal) for i in items):
                raise NotImplementedError("varchar IN requires literal list")
            wanted = {str(i.value) for i in items}
            lut = np.isin(dict_.values, list(wanted))
            if not len(lut):
                lut = np.zeros(1, dtype=np.bool_)
            lut_dev = torch.from_numpy(lut).to(self.device)

            def ev_str(env):
                data, valid = a.fn(env)
                return lut_dev[data.long().clamp(0, len(lut) - 1)], valid

            return CompiledExpr(ev_str, T.BOOLEAN)
        compiled_items = [self.compile(i) for i in items]

        def ev(env):
            data, valid = a.fn(env)
            out = None
            any_null_item = None
            for ci in compiled_items:
                d, v = ci.fn(env)
                hit = data == d
                if v is not None:
                    hit = hit & v
                    item_null = ~v
                    any_null_item = (
                        item_null if any_null_item is None
                        else any_null_item | item_null
                    )
                out = hit if out is None else out | hit
            if any_null_item is not None:
                # 3VL: no match + a NULL item -> NULL, not FALSE
                valid = _and_valid(valid, out | ~any_null_item)
            return out, valid

        return CompiledExpr(ev, T.BOOLEAN)

    def _comparison(self, expr: Call) -> CompiledExpr:
        lhs, rhs = expr.args
        a = self.compile(lhs)
        b = self.compile(rhs)
        if isinstance(lhs.type, T.VarcharType) or isinstance(rhs.type, T.VarcharType):
            return self._string_comparison(expr, a, b)
        a_long = isinstance(lhs.type, T.DecimalType) and lhs.type.is_long
        b_long = isinstance(rhs.type, T.DecimalType) and rhs.type.is_long
        if a_long or b_long:
            return self._limb_comparison(expr, a, b, a_long, b_long)
        if (
            isinstance(lhs.type, T.DecimalType)
            and isinstance(rhs.type, T.DecimalType)
            and lhs.type.scale != rhs.type.scale
        ):
            return self._mixed_scale_comparison(expr, a, b)
        op = _CMP_OPS[expr.name]

        def ev(env):
            a_d, a_v = a.fn(env)
            b_d, b_v = b.fn(env)
            return op(a_d, b_d), _and_valid(a_v, b_v)

        return CompiledExpr(ev, T.BOOLEAN)

    def _limb_comparison(
        self, expr: Call, a: CompiledExpr, b: CompiledExpr,
        a_long: bool, b_long: bool,
    ) -> CompiledExpr:
        """Exact comparison on two-limb decimals: numeric order equals
        lexicographic (hi, lo) order (lo canonical non-negative)."""
        if a.type.scale != b.type.scale:
            raise NotImplementedError(
                "mixed-scale long-decimal comparison"
            )
        name = expr.name

        def limbs(c, is_long):
            def get(env):
                d, v = c.fn(env)
                if is_long:
                    return d[..., 0], d[..., 1], v
                return d >> 32, d & 0xFFFFFFFF, v

            return get

        ga = limbs(a, a_long)
        gb = limbs(b, b_long)

        def ev(env):
            ah, al, av = ga(env)
            bh, bl, bv = gb(env)
            if name == "eq":
                out = (ah == bh) & (al == bl)
            elif name == "ne":
                out = (ah != bh) | (al != bl)
            elif name == "lt":
                out = (ah < bh) | ((ah == bh) & (al < bl))
            elif name == "le":
                out = (ah < bh) | ((ah == bh) & (al <= bl))
            elif name == "gt":
                out = (ah > bh) | ((ah == bh) & (al > bl))
            else:  # ge
                out = (ah > bh) | ((ah == bh) & (al >= bl))
            return out, _and_valid(av, bv)

        return CompiledExpr(ev, T.BOOLEAN)

    def _mixed_scale_comparison(self, expr: Call, a: CompiledExpr, b: CompiledExpr) -> CompiledExpr:
        """Exact decimal comparison across scales without rescaling:
        with m = 10^(s_b - s_a), q = floor(b / m), r = b - q*m, compare
        (a, 0) with (q, r) lexicographically."""
        name = expr.name
        if a.type.scale > b.type.scale:
            return self._mixed_scale_comparison(
                Call(
                    T.BOOLEAN,
                    _MIRRORED_CMP.get(name, name),
                    (expr.args[1], expr.args[0]),
                ),
                b, a,
            )
        m = 10 ** (b.type.scale - a.type.scale)

        def ev(env):
            a_d, a_v = a.fn(env)
            b_d, b_v = b.fn(env)
            q = torch.div(b_d, m, rounding_mode="floor")
            r = b_d - q * m
            if name == "eq":
                out = (a_d == q) & (r == 0)
            elif name == "ne":
                out = (a_d != q) | (r != 0)
            elif name == "lt":
                out = (a_d < q) | ((a_d == q) & (r > 0))
            elif name == "le":
                out = a_d <= q
            elif name == "gt":
                out = a_d > q
            else:  # ge
                out = (a_d > q) | ((a_d == q) & (r == 0))
            return out, _and_valid(a_v, b_v)

        return CompiledExpr(ev, T.BOOLEAN)

    def _string_comparison(self, expr: Call, a: CompiledExpr, b: CompiledExpr) -> CompiledExpr:
        op = _CMP_OPS[expr.name]
        if a.is_literal and not b.is_literal:
            name = _MIRRORED_CMP.get(expr.name, expr.name)
            return self._string_comparison(
                Call(T.BOOLEAN, name, (expr.args[1], expr.args[0])), b, a
            )
        if a.dictionary is not None and b.dictionary is not None:
            if b.is_literal:
                s = str(b.dictionary.values[0])
                code, exact = _code_bound(a.dictionary, s)
                # an absent literal's code is its insertion point
                name = expr.name
                if not exact:
                    name = {"le": "lt", "gt": "ge"}.get(name, name)

                def ev_lit(env):
                    a_d, a_v = a.fn(env)
                    if name == "eq":
                        r = (a_d == code) if exact else torch.zeros_like(a_d, dtype=torch.bool)
                    elif name == "ne":
                        r = (a_d != code) if exact else torch.ones_like(a_d, dtype=torch.bool)
                    else:
                        r = _CMP_OPS[name](a_d, code)
                    return r, a_v

                return CompiledExpr(ev_lit, T.BOOLEAN)
            if a.dictionary is b.dictionary:
                def ev_shared(env):
                    a_d, a_v = a.fn(env)
                    b_d, b_v = b.fn(env)
                    return op(a_d, b_d), _and_valid(a_v, b_v)

                return CompiledExpr(ev_shared, T.BOOLEAN)
            merged, remap_a, remap_b = a.dictionary.union(b.dictionary)
            ra = _remap_gather(remap_a, self.device)
            rb = _remap_gather(remap_b, self.device)

            def ev_merged(env):
                a_d, a_v = a.fn(env)
                b_d, b_v = b.fn(env)
                return op(ra(a_d), rb(b_d)), _and_valid(a_v, b_v)

            return CompiledExpr(ev_merged, T.BOOLEAN)
        raise NotImplementedError(
            "varchar comparison requires a literal or a shared dictionary"
        )

    def _arith(self, expr: Call) -> CompiledExpr:
        lhs, rhs = expr.args
        a = self.compile(lhs)
        b = self.compile(rhs)
        name = expr.name
        out_t = expr.type
        if isinstance(out_t, T.DecimalType):
            if out_t.is_long:
                raise NotImplementedError("_decimal_arith: decimal(38) operands")
            return self._decimal_arith(expr, a, b)
        out_dtype = torch_dtype(out_t.np_dtype)
        ops = {
            "add": torch.add,
            "subtract": torch.sub,
            "multiply": torch.mul,
        }
        if name in ops:
            op = ops[name]

            def ev(env):
                a_d, a_v = a.fn(env)
                b_d, b_v = b.fn(env)
                return op(a_d, b_d).to(out_dtype), _and_valid(a_v, b_v)

            return CompiledExpr(ev, out_t)
        if name == "divide":
            if out_t.is_integer:
                def ev_idiv(env):
                    a_d, a_v = a.fn(env)
                    b_d, b_v = b.fn(env)
                    safe = torch.where(b_d == 0, torch.ones_like(b_d), b_d)
                    q = _int_div_trunc(a_d, safe)
                    # division by zero nulls the row
                    return q.to(out_dtype), _and_valid(
                        _and_valid(a_v, b_v), b_d != 0
                    )

                return CompiledExpr(ev_idiv, out_t)

            def ev_fdiv(env):
                a_d, a_v = a.fn(env)
                b_d, b_v = b.fn(env)
                return (a_d / b_d).to(out_dtype), _and_valid(a_v, b_v)

            return CompiledExpr(ev_fdiv, out_t)
        if name == "modulus":
            def ev_mod(env):
                a_d, a_v = a.fn(env)
                b_d, b_v = b.fn(env)
                safe = torch.where(b_d == 0, torch.ones_like(b_d), b_d)
                r = a_d - _int_div_trunc(a_d, safe) * safe
                return r.to(out_dtype), _and_valid(
                    _and_valid(a_v, b_v), b_d != 0
                )

            return CompiledExpr(ev_mod, out_t)
        raise NotImplementedError(f"_arith: {name}")

    def _decimal_arith(self, expr: Call, a: CompiledExpr, b: CompiledExpr) -> CompiledExpr:
        """Decimal arithmetic on unscaled int64 (round half-up on
        divide)."""
        out_t: T.DecimalType = expr.type  # type: ignore[assignment]
        name = expr.name
        s_a = a.type.scale if isinstance(a.type, T.DecimalType) else 0
        s_b = b.type.scale if isinstance(b.type, T.DecimalType) else 0

        def ev(env):
            a_d, a_v = a.fn(env)
            b_d, b_v = b.fn(env)
            valid = _and_valid(a_v, b_v)
            a_i = a_d.to(I64)
            b_i = b_d.to(I64)
            if name in ("add", "subtract"):
                a_i = a_i * 10 ** (out_t.scale - s_a)
                b_i = b_i * 10 ** (out_t.scale - s_b)
                out = a_i + b_i if name == "add" else a_i - b_i
            elif name == "multiply":
                out = a_i * b_i  # scale s_a + s_b == out_t.scale
            elif name == "divide":
                shift = out_t.scale - s_a + s_b
                num = a_i * 10**shift
                safe = torch.where(b_i == 0, torch.ones_like(b_i), b_i)
                out = _div_round_half_up(num, safe)
                valid = _and_valid(valid, b_i != 0)
            elif name == "modulus":
                safe = torch.where(b_i == 0, torch.ones_like(b_i), b_i)
                out = a_i - _int_div_trunc(a_i, safe) * safe
                valid = _and_valid(valid, b_i != 0)
            else:
                raise NotImplementedError(f"_decimal_arith: {name}")
            return out, valid

        return CompiledExpr(ev, out_t)

    def _string_predicate(self, expr: Call) -> CompiledExpr:
        """LIKE, NOT LIKE and regexp_like: evaluated on the host over the
        dictionary's values at compile time into a bool table, applied on
        the device as a gather by code (clamped, as the JAX package's
        ``mode="clip"`` take). The table is cached with the dictionary,
        so a scan-cached column pays the host pass once."""
        a = self.compile(expr.args[0])
        if a.dictionary is None:
            raise NotImplementedError(f"{expr.name} requires a dictionary input")
        pattern = str(expr.args[1].value)  # type: ignore[attr-defined]
        values = a.dictionary.values

        def build():
            if expr.name in ("like", "not_like"):
                matcher = re.compile(_like_to_regex(pattern), re.DOTALL).fullmatch
            else:
                # Trino's regexp_like is a search (substring match), not
                # a full match
                matcher = re.compile(pattern).search
            lut = np.fromiter(
                (matcher(str(v)) is not None for v in values),
                dtype=np.bool_, count=len(values),
            )
            if expr.name == "not_like":
                lut = ~lut
            return _clamped_gather(
                lut if len(lut) else np.zeros(1, np.bool_), self.device
            )

        gather = _dictionary_derived(
            a.dictionary, (expr.name, pattern, str(self.device)), build
        )

        def ev(env):
            data, valid = a.fn(env)
            return gather(data), valid

        return CompiledExpr(ev, T.BOOLEAN)

    def _string_transform(self, expr: Call) -> CompiledExpr:
        """substr, lower, upper, ...: the values of the dictionary are
        transformed on the host into a new sorted dictionary; the device
        op is a code-remap gather (plus a per-code NULL table for
        transforms that can return NULL)."""
        a = self.compile(expr.args[0])
        if a.dictionary is None:
            raise NotImplementedError(f"{expr.name} requires a dictionary input")
        f = _STRING_TRANSFORMS[expr.name]
        lits = [l.value for l in expr.args[1:]]  # type: ignore[attr-defined]
        values = a.dictionary.values

        def build():
            try:
                raw = [f(str(v), *lits) for v in values]
            except (re.error, IndexError) as e:
                raise ValueError(f"{expr.name}: {e}") from e
            null_lut = np.fromiter(
                (v is None for v in raw), dtype=np.bool_, count=len(raw)
            )
            transformed = np.asarray(
                ["" if v is None else v for v in raw], dtype=object
            )
            if len(transformed):
                new_dict, codes = StringDictionary.from_strings(transformed)
            else:
                new_dict = StringDictionary(np.asarray([], dtype=object))
                codes = np.zeros(1, dtype=np.int32)
            null_at = (
                _clamped_gather(null_lut, self.device) if null_lut.any()
                else None
            )
            return new_dict, _clamped_gather(codes, self.device), null_at

        new_dict, remap, null_at = _dictionary_derived(
            a.dictionary, (expr.name, repr(lits), str(self.device)), build
        )

        def ev(env):
            data, valid = a.fn(env)
            out = remap(data)
            if null_at is not None:
                notnull = ~null_at(data)
                valid = notnull if valid is None else (valid & notnull)
            return out, valid

        return CompiledExpr(ev, expr.type, new_dict)

    def _simple(self, expr: Call) -> CompiledExpr:
        parts = [self.compile(a) for a in expr.args]
        f = _SIMPLE_FNS[expr.name]
        out_dtype = torch_dtype(expr.type.np_dtype)

        def ev(env):
            vals = [p.fn(env) for p in parts]
            datas = [d for d, _ in vals]
            valid = None
            for _, v in vals:
                valid = _and_valid(valid, v)
            return f(*datas).to(out_dtype), valid

        return CompiledExpr(ev, expr.type)


# ---- helpers -------------------------------------------------------------

def _lanes(cond: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """A row condition broadcast over trailing lanes ([n, 2] limbs)."""
    if data.dim() == 2 and cond.dim() == 1:
        return cond[:, None]
    return cond


def _literal_device_value(expr: Literal):
    v = expr.value
    if isinstance(expr.type, T.DateType) and isinstance(v, str):
        return T.parse_date(v)
    if isinstance(expr.type, T.TimestampType) and isinstance(v, str):
        return T.parse_timestamp(v)
    if isinstance(expr.type, T.DecimalType):
        from decimal import Decimal

        return int(
            (Decimal(str(v)) * (10 ** expr.type.scale)).to_integral_value()
        )
    return v


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _int_div_trunc(a, b):
    """C-style truncating integer division (SQL semantics)."""
    q = _floordiv(a, b)
    r = a - q * b
    fix = (r != 0) & ((a < 0) != (b < 0))
    return q + fix.to(q.dtype)


def _div_round_half_up(a, b):
    """Integer divide rounding half away from zero (Trino decimal rule)."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    sign = torch.where((a < 0) != (b < 0), -1, 1).to(a.dtype)
    aa = torch.abs(a)
    ab = torch.abs(b)
    return sign * _floordiv(aa + _floordiv(ab, 2), ab)


def _code_bound(d: StringDictionary, s: str) -> tuple[int, bool]:
    """(code position of s in dictionary, whether s is present)."""
    i = int(np.searchsorted(d.values, s))
    exact = i < len(d.values) and d.values[i] == s
    if not exact and i == len(d.values):
        return len(d.values), False
    return i, exact


def _merge_result_dicts(out_type, parts):
    if not isinstance(out_type, T.VarcharType):
        return None
    # a dictionary-less varchar branch is acceptable only as a typed
    # NULL literal
    if any(p.dictionary is None and not p.is_literal for p in parts):
        raise NotImplementedError(
            "varchar branches must be dictionary-backed"
        )
    empty = StringDictionary(np.asarray([], dtype=object))
    dicts = [p.dictionary if p.dictionary is not None else empty for p in parts]
    merged = dicts[0]
    for d in dicts[1:]:
        if d is not merged:
            merged, _, _ = merged.union(d)
    return merged


def _redict_fn(part: CompiledExpr, merged: StringDictionary | None, device):
    """Compile-time code remap onto a merged dictionary (device gather)."""
    if merged is None or part.dictionary is merged or part.dictionary is None:
        return lambda data: data
    remap = np.searchsorted(merged.values, part.dictionary.values).astype(np.int32)
    return _remap_gather(remap, device)


def _remap_gather(remap: np.ndarray, device):
    if len(remap) == 0:
        return lambda data: data
    return _clamped_gather(remap, device)


#: derived tables kept per dictionary; each may be a device table the
#: size of the dictionary (and a transform's new host dictionary), which
#: no memory pool counts, so ad-hoc patterns evict the least recent
DERIVED_PER_DICTIONARY = 4


def _dictionary_derived(d: StringDictionary, key, build):
    """``build()``'s result for (dictionary, key), computed once and kept
    with the dictionary (a scan-cached column's dictionary lives across
    queries, so warm runs skip the host pass over its values), for the
    ``DERIVED_PER_DICTIONARY`` most recently used keys."""
    hit = d.derived.get(key)
    if hit is None:
        hit = build()
        d.derived[key] = hit
        while len(d.derived) > DERIVED_PER_DICTIONARY:
            d.derived.popitem(last=False)
    else:
        d.derived.move_to_end(key)
    return hit


def _clamped_gather(table: np.ndarray, device):
    """A device lookup ``table[clamp(code)]`` (the JAX package's
    ``jnp.take(..., mode="clip")``) of a non-empty host table."""
    dev_table = torch.from_numpy(np.ascontiguousarray(table)).to(device)
    top = len(table) - 1
    return lambda data: dev_table[data.long().clamp(0, top)]


def _like_to_regex(pattern: str, escape: str | None = None) -> str:
    """A SQL LIKE pattern as a Python regex (``%`` any run, ``_`` one
    character, ``escape`` quoting the next character)."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "".join(out)


_CMP_OPS = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
}

#: operator under argument swap: a OP b == b MIRROR(OP) a
_MIRRORED_CMP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}

_STRING_PREDICATES = {"like", "not_like", "regexp_like"}

_STRING_TRANSFORMS: dict[str, Callable] = {
    "substr": lambda s, start, length=None: (
        s[int(start) - 1 : int(start) - 1 + int(length)]
        if length is not None
        else s[int(start) - 1 :]
    ),
    "lower": lambda s: s.lower(),
    "upper": lambda s: s.upper(),
    "trim": lambda s: s.strip(),
    "ltrim": lambda s: s.lstrip(),
    "rtrim": lambda s: s.rstrip(),
    "reverse": lambda s: s[::-1],
    "replace": lambda s, find, repl="": s.replace(find, repl),
    # || with a literal operand (ConcatFunction over dictionary values)
    "concat_suffix": lambda s, suffix: s + str(suffix),
    "concat_prefix": lambda s, prefix: str(prefix) + s,
    # Trino regex semantics (JoniRegexpFunctions): extract returns the
    # group (NULL-as-empty here: dictionary transforms cannot produce
    # NULL) or '' when unmatched; replace substitutes every match
    "regexp_extract": lambda s, pattern, group=0: (
        (lambda m: (m.group(int(group)) or "") if m else None)(
            re.search(str(pattern), s)
        )
    ),
    "regexp_replace": lambda s, pattern, repl="": re.sub(
        str(pattern),
        _java_replacement(
            str(repl), re.compile(str(pattern)).groups
        ),
        s,
    ),
}


def _java_replacement(repl: str, n_groups: int) -> str:
    r"""Java appendReplacement semantics (what Trino's regexp_replace
    uses) -> python re.sub replacement: $N group references backtrack
    to the largest VALID group number ($10 with one group = group 1 +
    literal '0'); backslash escapes the next character literally; the
    output escapes python's own backslash handling."""
    def lit(c: str) -> str:
        return "\\\\" if c == "\\" else c

    out = []
    i = 0
    while i < len(repl):
        c = repl[i]
        if c == "\\" and i + 1 < len(repl):
            out.append(lit(repl[i + 1]))
            i += 2
            continue
        if c == "$":
            j = i + 1
            while j < len(repl) and repl[j].isdigit():
                j += 1
            # backtrack to the largest group number the pattern has
            while j > i + 1 and int(repl[i + 1:j]) > max(n_groups, 0) \
                    and j - (i + 1) > 1:
                j -= 1
            if j > i + 1:
                out.append(f"\\g<{repl[i + 1:j]}>")
                i = j
                continue
        out.append(lit(c))
        i += 1
    return "".join(out)


# ---- civil-date helpers (Howard Hinnant's algorithms) ---------------------

def _extract_civil(days):
    """Gregorian (y, m, d) of epoch days."""
    z = days.to(I64) + 719_468
    era = _floordiv(z, 146_097)
    doe = z - era * 146_097
    yoe = _floordiv(
        doe - _floordiv(doe, 1460) + _floordiv(doe, 36_524)
        - _floordiv(doe, 146_096), 365,
    )
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(I64)
    return y, m, d


def _days_from_civil(y, m, d):
    """Inverse of _extract_civil: (y, m, d) -> epoch days."""
    y = y - (m <= 2).to(I64)
    era = _floordiv(y, 400)
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = _floordiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return era * 146_097 + doe - 719_468


def _days_in_month(y, m):
    ny = y + (m == 12).to(I64)
    nm = torch.where(m == 12, 1, m + 1)
    one = torch.ones_like(y)
    return _days_from_civil(ny, nm, one) - _days_from_civil(y, m, one)


def _add_months_days(days, months):
    """date + n months with end-of-month day clamping."""
    y, m, d = _extract_civil(days)
    m0 = y * 12 + (m - 1) + months.to(I64)
    y2 = _floordiv(m0, 12)
    m2 = m0 - y2 * 12 + 1
    d2 = torch.minimum(d, _days_in_month(y2, m2))
    return _days_from_civil(y2, m2, d2)


_SIMPLE_FNS: dict[str, Callable] = {
    "extract_year": lambda d: _extract_civil(d)[0],
    "extract_month": lambda d: _extract_civil(d)[1],
    "extract_day": lambda d: _extract_civil(d)[2],
    "extract_quarter": lambda d: _floordiv(_extract_civil(d)[1] - 1, 3) + 1,
    "add_months": _add_months_days,
    "abs": torch.abs,
}
