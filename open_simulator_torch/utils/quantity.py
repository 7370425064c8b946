"""Kubernetes resource.Quantity parsing/formatting.

Reimplements the subset of k8s.io/apimachinery/pkg/api/resource.Quantity semantics the
simulator needs (reference uses it everywhere, e.g. reference pkg/simulator/plugin/
simon.go:45-68 via resourcehelper.PodRequestsAndLimits): binary suffixes (Ki..Ei), decimal
suffixes (k..E, and m for milli), plain integers/decimals, and scientific notation.

Values are held as exact integers of the smallest unit we care about:
- `parse_quantity` returns a float of the *base unit* (bytes, cores, counts).
- `parse_milli` returns integer milli-units (k8s CPU math is done in milli-cores;
  kube-scheduler's Resource struct stores MilliCPU + bytes).
"""

from __future__ import annotations

import re
from decimal import Decimal
from functools import lru_cache

_BIN = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3, "Ti": 1024**4, "Pi": 1024**5, "Ei": 1024**6}
_DEC = {
    "n": Decimal("1e-9"),
    "u": Decimal("1e-6"),
    "m": Decimal("1e-3"),
    "": Decimal(1),
    "k": Decimal(1000),
    "M": Decimal(1000**2),
    "G": Decimal(1000**3),
    "T": Decimal(1000**4),
    "P": Decimal(1000**5),
    "E": Decimal(1000**6),
}

_QUANT_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>[0-9]+(?:\.[0-9]*)?|\.[0-9]+)"
    r"(?:(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|[numkMGTPE])|(?P<exp>[eE][+-]?[0-9]+))?$"
)


class InvalidQuantity(ValueError):
    pass


def parse_decimal(value) -> Decimal:
    """Parse a k8s quantity (str/int/float) into an exact Decimal of base units."""
    if isinstance(value, bool):
        raise InvalidQuantity(f"boolean is not a quantity: {value!r}")
    if isinstance(value, str):
        return _parse_decimal_str(value)
    if isinstance(value, (int, float)):
        return Decimal(str(value))
    if value is None:
        return Decimal(0)
    return _parse_decimal_str(str(value))


@lru_cache(maxsize=65536)
def _parse_decimal_str(value: str) -> Decimal:
    s = value.strip()
    if not s:
        return Decimal(0)
    m = _QUANT_RE.match(s)
    if not m:
        raise InvalidQuantity(f"unparseable quantity: {s!r}")
    num = Decimal(m.group("num"))
    if m.group("sign") == "-":
        num = -num
    suffix = m.group("suffix")
    if suffix:
        if suffix in _BIN:
            num *= _BIN[suffix]
        else:
            num *= _DEC[suffix]
    elif m.group("exp"):
        num *= Decimal(10) ** int(m.group("exp")[1:])
    return num


def parse_quantity(value) -> float:
    """Quantity → float of base units (cores, bytes, counts)."""
    return float(parse_decimal(value))


def parse_milli(value) -> int:
    """Quantity → integer milli-units, rounding up like k8s ScaledValue(resource.Milli)."""
    d = parse_decimal(value) * 1000
    i = int(d)
    if d != i and d > 0:
        i += 1  # k8s rounds up when scaling down to milli
    return i


def format_quantity(value: float, binary: bool = False) -> str:
    """Pretty-print base-unit value, picking the largest clean suffix (report output only)."""
    if value == 0:
        return "0"
    if binary:
        for suf in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
            f = _BIN[suf]
            if value % f == 0:
                return f"{int(value // f)}{suf}"
        # fall through: not a clean multiple of any binary suffix
    if float(value).is_integer():
        return str(int(value))
    milli = value * 1000
    if float(milli).is_integer():
        return f"{int(milli)}m"
    return f"{value:g}"
