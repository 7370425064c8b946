"""Typed kernel contracts: lightweight shape/dtype declarations for device code.

A contract is a spec string per parameter (plus optionally ``ret``), attached
with the :func:`shaped` decorator::

    @shaped(pernode="[N] f32", zones="[N] i32", ret="[N] f32")
    def selector_spread_score(pernode, F, zones, Z, maxN=None): ...

Grammar (``parse_spec``)::

    spec  ::= dims? dtype
    dims  ::= "[" (dim ("," dim)*)? "]"          # "[]" = scalar
    dim   ::= NAME | INT | "..."                 # symbolic axis, literal, rest
    dtype ::= f32 | f64 | i32 | i64 | u32 | bool | any

Symbolic axis names (``N``, ``R``, ``G`` ...) are documentation-grade: they
tie a kernel's tensors to the batch-table axes defined in encode.py. The
decorator is a **zero-cost annotation** — it validates the spec strings and
parameter names once at import time, stores the parsed contract on
``fn.__shaped__``, and returns the function unchanged (no call-time wrapper:
these functions sit inside jit traces where a Python wrapper per call would
show up in trace time).

simonlint's ``contract-spec`` rule cross-checks the same grammar statically,
so a typo'd contract fails both at import and in CI lint. ``check_args`` is
an opt-in runtime verifier for tests.

No JAX import here: the static analyzer loads this module, and it must stay
importable (fast) on lint-only hosts.
"""

from __future__ import annotations

import inspect
import re
from typing import Dict, NamedTuple, Optional, Tuple

DTYPES = ("f32", "f64", "i32", "i64", "u32", "bool", "any")

_SPEC_RE = re.compile(
    r"^\s*(?:\[(?P<dims>[^\]]*)\]\s*)?(?P<dtype>[A-Za-z0-9]+)\s*$")
_DIM_RE = re.compile(r"^(?:[A-Za-z_][A-Za-z0-9_]*|\d+|\.\.\.)$")


class Spec(NamedTuple):
    """One parsed contract entry. dims is None for 'any shape' (no brackets)."""

    dims: Optional[Tuple[str, ...]]
    dtype: str

    def __str__(self) -> str:
        d = "" if self.dims is None else "[" + ", ".join(self.dims) + "] "
        return f"{d}{self.dtype}"


def parse_spec(text: str) -> Spec:
    """Parse a contract spec string; raises ValueError with a precise reason."""
    m = _SPEC_RE.match(text)
    if not m:
        raise ValueError(f"{text!r} is not 'dims? dtype' (e.g. '[N, R] f32')")
    dtype = m.group("dtype")
    if dtype not in DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; expected one of {DTYPES}")
    raw = m.group("dims")
    if raw is None:
        return Spec(dims=None, dtype=dtype)
    dims: Tuple[str, ...] = tuple(
        d.strip() for d in raw.split(",") if d.strip()) if raw.strip() else ()
    for d in dims:
        if not _DIM_RE.match(d):
            raise ValueError(f"bad axis name {d!r} in {text!r}")
    return Spec(dims=dims, dtype=dtype)


_NP_KINDS = {  # numpy/jax dtype -> contract dtype token
    "float32": "f32", "float64": "f64",
    "int32": "i32", "int64": "i64", "uint32": "u32", "bool": "bool",
}


def shaped(**specs: str):
    """Attach shape/dtype contracts to a kernel. Validates at import time that
    every key names a real parameter (or 'ret') and every spec parses; stores
    ``fn.__shaped__ = {name: Spec}``; returns ``fn`` unchanged."""

    def deco(fn):
        params = set(inspect.signature(fn).parameters)
        parsed: Dict[str, Spec] = {}
        for name, text in specs.items():
            if name not in params and name not in ("ret", "returns"):
                raise TypeError(
                    f"@shaped on {fn.__qualname__}: {name!r} is not a parameter")
            parsed[name] = parse_spec(text)
        fn.__shaped__ = parsed
        return fn

    return deco


def contract_of(fn) -> Dict[str, Spec]:
    """The declared contract, following jit/functools wrappers if needed."""
    for obj in (fn, getattr(fn, "__wrapped__", None)):
        got = getattr(obj, "__shaped__", None)
        if got:
            return got
    return {}


def check_args(fn, *args, **kwargs) -> None:
    """Opt-in runtime verifier (used by tests, never on hot paths): binds the
    call and checks every contracted argument's rank + dtype against its spec.
    Symbolic axes must be consistent within the call; '...' matches any tail."""
    contract = contract_of(fn)
    if not contract:
        return
    bound = inspect.signature(fn).bind_partial(*args, **kwargs)
    env: Dict[str, int] = {}
    for name, spec in contract.items():
        if name in ("ret", "returns") or name not in bound.arguments:
            continue
        val = bound.arguments[name]
        shape = tuple(getattr(val, "shape", ()))
        dt = str(getattr(val, "dtype", type(val).__name__))
        want = _NP_KINDS.get(dt, dt)
        if spec.dtype not in ("any", want):
            raise TypeError(
                f"{fn.__qualname__}: {name} dtype {dt} != spec {spec}")
        if spec.dims is None or "..." in spec.dims:
            continue
        if len(shape) != len(spec.dims):
            raise TypeError(
                f"{fn.__qualname__}: {name} rank {len(shape)} != spec {spec}")
        for axis, size in zip(spec.dims, shape):
            if axis.isdigit():
                if int(axis) != size:
                    raise TypeError(
                        f"{fn.__qualname__}: {name} axis {axis} is {size}")
            elif env.setdefault(axis, size) != size:
                raise TypeError(
                    f"{fn.__qualname__}: axis {axis} = {env[axis]} but {name} "
                    f"has {size}")
