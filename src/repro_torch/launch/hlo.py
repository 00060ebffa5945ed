"""Post-SPMD HLO analysis: collective inventory + wire-byte estimates.

Parses ``compiled.as_text()`` (partitioned, optimized HLO — per-device
shapes) for every collective op. Wire bytes per device use standard
ring-algorithm factors with the group size n taken from replica_groups:

  all-reduce         2 (n-1)/n x bytes(out)
  all-gather           (n-1)/n x bytes(out)
  reduce-scatter       (n-1)   x bytes(out)   (input = n x out)
  all-to-all           (n-1)/n x bytes(out)
  collective-permute             bytes(out)
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(type_str: str) -> int:
    m = _SHAPE_RE.match(type_str.strip())
    if not m:
        return 0
    dt, dims = m.group(1), m.group(2)
    if dt not in DTYPE_BYTES:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * DTYPE_BYTES[dt]


def _result_bytes(line: str) -> int:
    """Bytes of the op's result — handles tuple results by summing."""
    m = re.search(r"=\s+(.*?)\s+(?:%?\w[\w\-.]*)\(", line)
    if not m:
        return 0
    t = m.group(1)
    if t.startswith("("):
        return sum(_shape_bytes(p) for p in t.strip("()").split(","))
    return _shape_bytes(t)


def _group_size(line: str) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return max(1, m.group(1).count(",") + 1)
    m = _GROUPS_IOTA_RE.search(line)
    if m:  # [n_groups,group_size] iota form
        return max(1, int(m.group(2)))
    return 2


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    result_bytes: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    wire_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    ops: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.wire_bytes.values()))

    def scaled(self, factor: float) -> "CollectiveStats":
        out = CollectiveStats()
        for k in self.counts:
            out.counts[k] = int(self.counts[k] * factor)
            out.result_bytes[k] = int(self.result_bytes[k] * factor)
            out.wire_bytes[k] = self.wire_bytes[k] * factor
        return out

    def merged(self, other: "CollectiveStats") -> "CollectiveStats":
        out = CollectiveStats()
        for src in (self, other):
            for k in src.counts:
                out.counts[k] += src.counts[k]
                out.result_bytes[k] += src.result_bytes[k]
                out.wire_bytes[k] += src.wire_bytes[k]
        return out

    def summary(self) -> Dict:
        return {"counts": dict(self.counts),
                "result_bytes": dict(self.result_bytes),
                "wire_bytes": {k: float(v)
                               for k, v in self.wire_bytes.items()},
                "total_wire_bytes": self.total_wire_bytes}


def _wire_factor(kind: str, n: int) -> float:
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind == "all-gather":
        return (n - 1) / n
    if kind == "reduce-scatter":
        return float(n - 1)
    if kind == "all-to-all":
        return (n - 1) / n
    return 1.0  # collective-permute


_DEF_RE = re.compile(r"^%?([\w.\-]+)\s*=\s*\(?(\w+)\[")
_CALL_RE = re.compile(r"=\s+\S+\s+([\w\-]+)\(([^)]*)\)")
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\([^)]*\)\s*->")


def _def_table(hlo_text: str):
    """name -> (result dtype, opcode, first-operand name, called-comp).
    Also returns the set of computations containing bf16 intermediates
    (fused convert round-trips hide the narrow dtype inside)."""
    table = {}
    bf16_comps = set()
    current = None
    for line in hlo_text.splitlines():
        s = line.strip()
        hdr = _COMP_HDR_RE.match(s)
        if hdr and "{" in s:
            current = hdr.group(1)
        if current and " bf16[" in s:
            bf16_comps.add(current)
        m = _DEF_RE.match(s)
        if not m:
            continue
        name, dtype = m.group(1), m.group(2)
        mc = _CALL_RE.search(s)
        mcalls = _CALLS_RE.search(s)
        op, arg0 = "", ""
        if mc:
            op = mc.group(1)
            args = [a.strip().lstrip("%") for a in mc.group(2).split(",")]
            arg0 = args[0] if args and args[0] else ""
        table[name] = (dtype, op, arg0,
                       mcalls.group(1) if mcalls else "")
    return table, bf16_comps


def _true_elem_dtype(name: str, table, hops: int = 4) -> Optional[str]:
    """Narrowest dtype along the convert/copy chain feeding a collective:
    XLA:CPU's float-normalization upcasts every bf16 value to f32 BEFORE
    SPMD partitioning, so collectives that would run bf16 on TPU appear
    as f32(convert(bf16(convert(f32 master)))). The wire dtype is the
    NARROWEST in the chain — the compute copy — not the original master
    (DESIGN.md hardware-adaptation; EXPERIMENTS.md §Roofline)."""
    table, bf16_comps = table
    seen = []
    for _ in range(hops):
        if name not in table:
            break
        dtype, op, arg0, calls = table[name]
        seen.append(dtype)
        # fused convert round-trip (f32->bf16->f32) hides bf16 inside the
        # fused computation
        if op == "fusion" and calls in bf16_comps and dtype == "f32":
            seen.append("bf16")
        if op in ("convert", "copy", "bitcast", "reshape", "transpose",
                  "fusion") and arg0 and arg0 in table:
            name = arg0
            continue
        break
    widths = [DTYPE_BYTES.get(d) for d in seen if d in DTYPE_BYTES]
    if not widths:
        return None
    narrowest = min(widths)
    for d in seen:
        if DTYPE_BYTES.get(d) == narrowest:
            return d
    return None


def parse_collectives(hlo_text: str) -> CollectiveStats:
    st = CollectiveStats()
    table = _def_table(hlo_text)  # (defs, bf16-computations)
    for line in hlo_text.splitlines():
        s = line.strip()
        for kind in COLLECTIVES:
            # match op invocation, incl. -start variants; skip -done
            if re.search(rf"\b{kind}(-start)?\(", s) and f"{kind}-done" \
                    not in s:
                rb = _result_bytes(s)
                n = _group_size(s)
                # dtype correction for XLA:CPU float normalization
                mc = _CALL_RE.search(s)
                md = _DEF_RE.match(s)
                if mc and md and md.group(2) == "f32":
                    arg0 = [a.strip().lstrip("%")
                            for a in mc.group(2).split(",")][0]
                    src = _true_elem_dtype(arg0, table)
                    if src in ("bf16", "f16"):
                        rb //= 2
                    elif src in ("s8", "u8", "f8e4m3fn", "f8e5m2"):
                        rb //= 4
                st.counts[kind] += 1
                st.result_bytes[kind] += rb
                st.wire_bytes[kind] += rb * _wire_factor(kind, n)
                st.ops.append((kind, rb, n))
                break
    return st


def count_while_trip_factor(hlo_text: str) -> List[int]:
    """Known trip counts of while loops (XLA annotates them)."""
    return [int(m) for m in
            re.findall(r'known_trip_count=\{"?n"?[:=]\s*"?(\d+)"?\}',
                       hlo_text)]


def overlap_stats(hlo_text: str) -> Dict[str, int]:
    """Compute/communication overlap evidence: async collectives
    (``*-start``/``*-done`` pairs) can hide behind compute; synchronous
    ones cannot. XLA's latency-hiding scheduler targets the async form —
    the ratio is the structural overlap headroom we report per cell."""
    async_n = sync_n = 0
    for line in hlo_text.splitlines():
        s = line.strip()
        for kind in COLLECTIVES:
            if re.search(rf"\b{kind}-start\(", s):
                async_n += 1
                break
            if re.search(rf"\b{kind}\(", s) and f"{kind}-done" not in s:
                sync_n += 1
                break
    return {"async_collectives": async_n, "sync_collectives": sync_n}
