"""Trip-count-aware analysis of optimized HLO (the port's own copy of
``repro/launch/hloanalysis.py``; pure ``re``, no JAX).

XLA's ``compiled.cost_analysis()`` counts a while-loop body ONCE, so any
program built around ``lax.scan`` (i.e. every layer-stacked model of the
reference) underreports FLOPs, bytes and collective traffic by ~n_layers.
This module re-derives the executed totals from ``compiled.as_text()``:

  * parses computations, builds a per-computation symbol table (op types),
  * extracts while-loop trip counts from their condition computations,
  * walks the call graph (ENTRY -> while bodies x trip, fusions, calls),
  * accounts:
      - ``flops``:        2 * prod(output dims) * prod(contraction dims)
                          for every dot (recursing into fusions),
      - ``hbm_bytes``:    operands + outputs of top-level ops (NOT fusion
                          internals — fused intermediates never touch HBM),
      - ``collectives``:  per-type wire bytes with ring-cost factors
                          (:func:`wire_bytes`) and participant-group sizes
                          from replica_groups.

The port has no HLO of its own: its dry run (``launch.dryrun``) counts an
eager step on ``meta`` tensors and takes :func:`wire_bytes` for the
collectives it counts.  The tests feed this module and the reference's the
same HLO text.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "f64": 8, "s32": 4, "u32": 4,
                "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8, "s16": 2,
                "u16": 2, "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "token": 0,
                "u2": 1, "s2": 1, "u4": 1, "s4": 1}

_COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
# "%name = TYPE op-name(operands), attrs"  (post-optimization HLO)
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\(?.*?\)?)\s+([\w\-]+)\((.*)$")
# greedy params group: signatures contain nested parens (tuple params)
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\((.*)\)\s*->")


def _shape_elems_bytes(stype: str) -> Tuple[int, int]:
    m = _SHAPE_RE.match(stype)
    if not m:
        return 0, 0
    n = 1
    if m.group(2):
        for d in m.group(2).split(","):
            n *= int(d)
    return n, n * _DTYPE_BYTES.get(m.group(1), 4)


def _tuple_bytes(type_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        n = 1
        if m.group(2):
            for d in m.group(2).split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES.get(m.group(1), 4)
    return total


@dataclasses.dataclass
class Op:
    name: str
    out_type: str
    opcode: str
    rest: str           # operands + attributes (raw text)
    operands: List[str]


@dataclasses.dataclass
class Computation:
    name: str
    params: Dict[str, str]          # param name -> type
    ops: List[Op]
    symbols: Dict[str, str]         # op name -> output type


def parse_hlo(text: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for raw in text.splitlines():
        line = raw.rstrip()
        if not line:
            continue
        mc = _COMP_RE.match(line)
        if mc and line.endswith("{"):
            params = {}
            for pm in re.finditer(r"%?([\w.\-]+):\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[\d,]*\](?:\{[^}]*\})?))", mc.group(2)):
                params[pm.group(1)] = pm.group(2)
            cur = Computation(mc.group(1), params, [], dict(params))
            comps[cur.name] = cur
            continue
        if line.strip() == "}":
            cur = None
            continue
        if cur is None:
            continue
        mo = _OP_RE.match(line)
        if not mo:
            continue
        name, otype, opcode, rest = mo.groups()
        operands = re.findall(r"%([\w.\-]+)", rest.split("),")[0])
        op = Op(name, otype, opcode, rest, operands)
        cur.ops.append(op)
        cur.symbols[name] = otype
    return comps


def _trip_count(comps: Dict[str, Computation], cond_name: str) -> int:
    cond = comps.get(cond_name)
    if cond is None:
        return 1
    consts = []
    for op in cond.ops:
        if op.opcode == "constant":
            # _OP_RE leaves rest = "<value>), attrs" after "constant("
            m = re.match(r"(\-?\d+)\)", op.rest.strip())
            if m:
                consts.append(int(m.group(1)))
    pos = [c for c in consts if c > 0]
    return max(pos) if pos else 1


def _dot_flops(comp: Computation, op: Op) -> float:
    out_elems, _ = _shape_elems_bytes(op.out_type)
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.rest)
    if not m or not op.operands:
        return 0.0
    lhs_type = comp.symbols.get(op.operands[0], "")
    sm = _SHAPE_RE.match(lhs_type)
    if not sm:
        return 0.0
    dims = [int(d) for d in sm.group(2).split(",")] if sm.group(2) else []
    contract = 1
    for i in (int(x) for x in m.group(1).split(",") if x):
        if i < len(dims):
            contract *= dims[i]
    return 2.0 * out_elems * contract


def _group_size(rest: str, default: int) -> int:
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]", rest)
    if m:
        return int(m.group(2))
    m = re.search(r"replica_groups=\{\{([\d,]+)\}", rest)
    if m:
        return len(m.group(1).split(","))
    return default


def wire_bytes(kind: str, out_bytes: float, group_size: int) -> float:
    """The bytes a participant puts on the wire for one collective of
    ``kind`` (an HLO collective name) whose output is ``out_bytes``, over
    a group of ``group_size`` on a ring: (g - 1) / g of the output for an
    all-gather, a reduce-scatter or an all-to-all, twice that for an
    all-reduce, the whole output for a collective-permute."""
    ring = (group_size - 1) / max(group_size, 1)
    factor = {"all-gather": ring, "reduce-scatter": ring,
              "all-reduce": 2 * ring, "all-to-all": ring,
              "collective-permute": 1.0}[kind]
    return out_bytes * factor


@dataclasses.dataclass
class Account:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_wire_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in _COLL_OPS})
    coll_count: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {c: 0 for c in _COLL_OPS})

    def add(self, other: "Account", mult: float = 1.0):
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        for c in _COLL_OPS:
            self.coll_wire_bytes[c] += other.coll_wire_bytes[c] * mult
            self.coll_count[c] += int(other.coll_count[c] * mult)


_SKIP_BYTES = {"parameter", "constant", "get-tuple-element", "tuple",
               "bitcast", "copy", "partition-id", "replica-id",
               "after-all", "iota", "while", "conditional"}


def _op_hbm_bytes(comp: Computation, op: Op) -> float:
    if op.opcode in _SKIP_BYTES:
        return 0.0
    # In-place-aliasable updates: XLA aliases the target buffer (donated /
    # loop-carried), so real HBM traffic is the UPDATE bytes, not the whole
    # buffer.  Charge update operands (+ the written region ~ update size),
    # skip the pass-through target and the full-size output.
    if op.opcode in ("dynamic-update-slice", "scatter"):
        total = 0.0
        for o in op.operands[1:]:
            t = comp.symbols.get(o)
            if t:
                total += _tuple_bytes(t)
        return 2.0 * float(total)      # read update + write region
    # slicing reads only the slice, not the whole operand
    if op.opcode in ("dynamic-slice", "slice", "gather"):
        return 2.0 * _tuple_bytes(op.out_type)   # read region + write out
    total = _tuple_bytes(op.out_type)
    for o in op.operands:
        t = comp.symbols.get(o)
        if t:
            total += _tuple_bytes(t)
    return float(total)


def _fusion_hbm_bytes(comps: Dict[str, Computation], comp: Computation,
                      op: Op) -> float:
    """HBM traffic of a fusion = what crosses its boundary, with slice
    awareness: an operand consumed only by slice/gather ops inside the fused
    computation contributes the *sliced* bytes; a root dynamic-update-slice
    writes only the update region (XLA aliases the target)."""
    mb = re.search(r"calls=%?([\w.\-]+)", op.rest)
    called = comps.get(mb.group(1)) if mb else None
    if called is None:
        return _op_hbm_bytes(comp, op)

    # ---- output side
    root = called.ops[-1] if called.ops else None
    if root is not None and root.opcode == "dynamic-update-slice":
        upd = 0.0
        for o in root.operands[1:]:
            t = called.symbols.get(o)
            if t:
                upd += _tuple_bytes(t)
        out_bytes = 2.0 * upd
    elif root is not None and root.opcode == "scatter":
        upd = 0.0
        for o in root.operands[1:]:        # indices + updates
            t = called.symbols.get(o)
            if t:
                upd += _tuple_bytes(t)
        out_bytes = 2.0 * upd
    else:
        out_bytes = float(_tuple_bytes(op.out_type))

    # ---- operand side: param index -> name
    param_name = {}
    for o in called.ops:
        if o.opcode == "parameter":
            m = re.match(r"(\d+)\)", o.rest.strip())
            if m:
                param_name[int(m.group(1))] = o.name
    total = out_bytes
    for i, operand in enumerate(op.operands):
        t = comp.symbols.get(operand)
        if not t:
            continue
        full = float(_tuple_bytes(t))
        pname = param_name.get(i)
        if pname is None:
            total += full
            continue
        consumers = [o for o in called.ops if pname in o.operands]
        if consumers and all(
            o.opcode in ("dynamic-slice", "slice", "gather")
            or (o.opcode == "dynamic-update-slice" and o.operands
                and o.operands[0] == pname)
            for o in consumers
        ):
            sliced = 0.0
            for o in consumers:
                if o.opcode == "dynamic-update-slice":
                    continue            # aliased target: counted on output
                sliced += _tuple_bytes(o.out_type)
            total += min(sliced, full)
        else:
            total += full
    return total


def analyze(text: str, n_devices_per_group: int = 16) -> dict:
    """Walk ENTRY with trip-count multipliers; returns executed totals
    (per-device, since post-SPMD HLO is the per-device program)."""
    comps = parse_hlo(text)
    entry = None
    for line in text.splitlines():
        if line.startswith("ENTRY"):
            m = _COMP_RE.match(line)
            if m:
                entry = m.group(1)
            break
    if entry is None:       # fall back: biggest computation
        entry = max(comps, key=lambda c: len(comps[c].ops))

    memo: Dict[str, Account] = {}

    def eval_comp(name: str, depth=0) -> Account:
        if name in memo:
            return memo[name]
        comp = comps.get(name)
        acc = Account()
        if comp is None or depth > 50:
            return acc
        memo[name] = acc    # pre-insert (cycle guard)
        for op in comp.ops:
            base = op.opcode.replace("-start", "") if op.opcode.endswith("-start") else op.opcode
            if op.opcode == "dot":
                acc.flops += _dot_flops(comp, op)
                acc.hbm_bytes += _op_hbm_bytes(comp, op)
            elif base in _COLL_OPS and not op.opcode.endswith("-done"):
                out_b = _tuple_bytes(op.out_type)
                g = _group_size(op.rest, n_devices_per_group)
                acc.coll_wire_bytes[base] += wire_bytes(base, out_b, g)
                acc.coll_count[base] += 1
                acc.hbm_bytes += _op_hbm_bytes(comp, op)
            elif op.opcode == "while":
                mb = re.search(r"body=%?([\w.\-]+)", op.rest)
                mc = re.search(r"condition=%?([\w.\-]+)", op.rest)
                trips = _trip_count(comps, mc.group(1)) if mc else 1
                if mb:
                    acc.add(eval_comp(mb.group(1), depth + 1), trips)
            elif op.opcode == "fusion":
                mb = re.search(r"calls=%?([\w.\-]+)", op.rest)
                if mb:
                    inner = eval_comp(mb.group(1), depth + 1)
                    # flops + collectives recurse; bytes = fusion boundary only
                    acc.flops += inner.flops
                    for c in _COLL_OPS:
                        acc.coll_wire_bytes[c] += inner.coll_wire_bytes[c]
                        acc.coll_count[c] += inner.coll_count[c]
                acc.hbm_bytes += _fusion_hbm_bytes(comps, comp, op)
            elif op.opcode in ("call", "async-start", "custom-call"):
                mb = re.search(r"(?:to_apply|calls)=%?([\w.\-]+)", op.rest)
                if mb:
                    acc.add(eval_comp(mb.group(1), depth + 1), 1.0)
                # A resolvable plain call's traffic is whatever its callee's
                # ops do — charging the call boundary too double-counts every
                # operand at full size (e.g. the CPU backend wraps gather
                # fusions in %parallel_* calls, turning a 4 KB sliced read
                # into the whole table).  Opaque targets (custom-call,
                # async-start without a parsed callee) still pay boundary
                # bytes since we cannot see inside them.
                if not (op.opcode in ("call", "async-start")
                        and mb and mb.group(1) in comps):
                    acc.hbm_bytes += _op_hbm_bytes(comp, op)
            elif op.opcode == "conditional":
                for mb in re.finditer(r"(?:branch_computations=\{([^}]*)\}|"
                                      r"(?:true|false)_computation=%?([\w.\-]+))",
                                      op.rest):
                    names = (mb.group(1) or mb.group(2) or "")
                    for nm in re.findall(r"%?([\w.\-]+)", names):
                        acc.add(eval_comp(nm, depth + 1), 1.0)
            else:
                acc.hbm_bytes += _op_hbm_bytes(comp, op)
        return acc

    acc = eval_comp(entry)
    return {
        "flops": acc.flops,
        "hbm_bytes": acc.hbm_bytes,
        "collective_wire_bytes": dict(acc.coll_wire_bytes),
        "collective_count": dict(acc.coll_count),
        "collective_total_bytes": float(sum(acc.coll_wire_bytes.values())),
    }
