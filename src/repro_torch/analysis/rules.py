"""The six repo invariants, as single-pass AST rules.

Port of ``repro.analysis.rules``: the same rules, node for node, with
the path-scoped ones (clock-discipline, tracer-guard, wire-safety)
pointed at ``src/repro_torch/``. ``rng-discipline`` also flags torch's
process-global generator (``torch.manual_seed`` and the samplers called
without ``generator=``): the same invariant, "RNG is a passed
generator", in the port's own language.

Each rule encodes a convention established by fixing a shipped bug (see
each rule's ``motivation``). Rules are event-driven: the ``Walker`` in
:mod:`repro_torch.analysis.core` offers every node of a module to every
applicable rule in document order, and per-scope state (import aliases,
taint sets, guard aliases) is pushed/popped on function boundaries via
``visit``/``leave``.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import FileContext, Rule, dotted_name

# ---------------------------------------------------------------------------
# clock-discipline
# ---------------------------------------------------------------------------

_WALL_CLOCK_FNS = {"time", "monotonic", "perf_counter",
                   "time_ns", "monotonic_ns", "perf_counter_ns"}


class ClockDisciplineRule(Rule):
    """No direct wall-clock reads in sim-clock domains.

    The engine, sync plane, serving layer, and executor/hedging all run
    on an injected clock so simulated and real deployments share one
    code path. A raw ``time.time()``/``monotonic()``/``perf_counter()``
    inside those domains mixes wall time into sim time — the
    ``maybe_tick`` back-dating bug made honest leases look forged, and
    the clock-domain split exists precisely to keep the two clock
    families apart. Deliberate wall-clock *measurement* sites (wall-us
    trace spans) carry allow-list entries with their justification.
    """

    rule_id = "clock-discipline"
    doc = ("no direct time.time()/monotonic()/perf_counter() in "
           "sim-clock domains; inject a clock")
    motivation = "maybe_tick back-dating; the clock-domain split"
    default_paths = ("src/repro_torch/serving/", "src/repro_torch/sync/",
                     "src/repro_torch/sim/", "src/repro_torch/core/")

    def begin_file(self, ctx: FileContext) -> None:
        self._module_aliases: Set[str] = set()   # import time [as _time]
        self._func_aliases: Set[str] = set()     # from time import X [as Y]

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    self._module_aliases.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "time":
                for a in node.names:
                    if a.name in _WALL_CLOCK_FNS:
                        self._func_aliases.add(a.asname or a.name)
        elif isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id in self._module_aliases
                    and f.attr in _WALL_CLOCK_FNS):
                ctx.add(self.rule_id, node,
                        f"direct wall-clock read {f.value.id}.{f.attr}() "
                        f"in a sim-clock domain; inject a clock")
            elif isinstance(f, ast.Name) and f.id in self._func_aliases:
                ctx.add(self.rule_id, node,
                        f"direct wall-clock read {f.id}() in a sim-clock "
                        f"domain; inject a clock")


# ---------------------------------------------------------------------------
# rng-discipline
# ---------------------------------------------------------------------------

_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "BitGenerator"}
#: torch functions that set the process-global generator
_TORCH_SEEDERS = {"manual_seed", "seed", "manual_seed_all"}
#: torch samplers that draw from it unless given ``generator=``
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial"}


class RngDisciplineRule(Rule):
    """All randomness flows through a passed ``np.random.Generator`` (or
    ``torch.Generator``) or a seed-derived ``default_rng``.

    The determinism contract (one RNG draw per hop, bit-identical across
    mono/sharded/process-split layers) dies the moment any module touches
    global RNG state: ``np.random.seed``/``np.random.rand`` are
    process-wide, stdlib ``random`` is process-wide, and an *unseeded*
    ``default_rng()`` is OS-entropy nondeterminism. So is torch's default
    generator: ``torch.manual_seed`` (and ``torch.seed``,
    ``torch.cuda.manual_seed[_all]``) set it for the whole process, and
    ``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
    ``bernoulli``/``multinomial`` draw from it unless given
    ``generator=``. All of these are flagged anywhere in
    ``src/repro_torch``.
    """

    rule_id = "rng-discipline"
    doc = ("no global np.random.* / stdlib random state; RNG is a passed "
           "Generator or seed-derived default_rng")
    motivation = "one-draw-per-hop determinism contract"
    default_paths = None   # everywhere we are pointed at

    def begin_file(self, ctx: FileContext) -> None:
        self._np: Set[str] = set()          # import numpy [as np]
        self._np_random: Set[str] = set()   # from numpy import random [as r]
        self._stdlib: Set[str] = set()      # import random [as r]
        self._default_rng: Set[str] = set()  # from numpy.random import ...
        self._stdlib_fns: Set[str] = set()  # from random import shuffle, ...
        self._torch: Set[str] = set()       # import torch [as t]
        self._torch_fns: Dict[str, str] = {}  # from torch import rand [as r]

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    self._np.add(a.asname or a.name)
                elif a.name == "numpy.random":
                    self._np_random.add(a.asname or "numpy.random")
                elif a.name == "random":
                    self._stdlib.add(a.asname or a.name)
                elif a.name == "torch":
                    self._torch.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "numpy":
                for a in node.names:
                    if a.name == "random":
                        self._np_random.add(a.asname or a.name)
            elif node.module == "numpy.random":
                for a in node.names:
                    if a.name == "default_rng":
                        self._default_rng.add(a.asname or a.name)
            elif node.module == "random":
                for a in node.names:
                    self._stdlib_fns.add(a.asname or a.name)
            elif node.module in ("torch", "torch.cuda"):
                for a in node.names:
                    if a.name in _TORCH_SEEDERS | _TORCH_SAMPLERS:
                        self._torch_fns[a.asname or a.name] = a.name
        elif isinstance(node, ast.Call):
            self._check_call(node, ctx)

    def _check_call(self, node: ast.Call, ctx: FileContext) -> None:
        name = dotted_name(node.func)
        if name is None:
            return
        parts = name.split(".")
        fn = parts[-1]
        head = ".".join(parts[:-1])
        if (head in self._np_random
                or (len(parts) >= 3 and ".".join(parts[:-2]) in self._np
                    and parts[-2] == "random")):
            if fn == "default_rng":
                if not node.args and not node.keywords:
                    ctx.add(self.rule_id, node,
                            "unseeded default_rng() — OS-entropy "
                            "nondeterminism; derive the seed from config")
            elif fn not in _NP_RANDOM_OK:
                ctx.add(self.rule_id, node,
                        f"global-state numpy RNG np.random.{fn}(); use a "
                        f"passed np.random.Generator")
        elif len(parts) == 2 and parts[0] in self._stdlib:
            ctx.add(self.rule_id, node,
                    f"stdlib random.{fn}() uses process-global state; use "
                    f"a passed np.random.Generator")
        elif head in self._torch or (len(parts) == 3 and parts[1] == "cuda"
                                     and parts[0] in self._torch):
            self._check_torch(node, fn, ctx)
        elif len(parts) == 1:
            if fn in self._default_rng:
                if not node.args and not node.keywords:
                    ctx.add(self.rule_id, node,
                            "unseeded default_rng() — OS-entropy "
                            "nondeterminism; derive the seed from config")
            elif fn in self._stdlib_fns:
                ctx.add(self.rule_id, node,
                        f"stdlib random.{fn}() uses process-global state; "
                        f"use a passed np.random.Generator")
            elif fn in self._torch_fns:
                self._check_torch(node, self._torch_fns[fn], ctx)

    def _check_torch(self, node: ast.Call, fn: str,
                     ctx: FileContext) -> None:
        if fn in _TORCH_SEEDERS:
            ctx.add(self.rule_id, node,
                    f"torch.{fn}() sets the process-global generator; use "
                    f"a passed torch.Generator")
        elif fn in _TORCH_SAMPLERS and not any(
                k.arg == "generator" for k in node.keywords):
            ctx.add(self.rule_id, node,
                    f"torch.{fn}() without generator= draws from the "
                    f"process-global generator; pass a torch.Generator")


# ---------------------------------------------------------------------------
# state-aliasing
# ---------------------------------------------------------------------------

_PRODUCER_METHODS = {"export_state", "export_shard_state", "mirror"}
_PRODUCER_FUNCS = {"registry_shard_state"}
_ADOPT_METHODS = {"adopt_state", "adopt_shard_state"}
_SANITIZERS = {"copy_state"}


@dataclass
class _AliasScope:
    tainted: Set[str] = field(default_factory=set)
    containers: Set[str] = field(default_factory=set)   # dict/list of tainted
    attr_derived: Set[str] = field(default_factory=set)  # hist = self._h[...]


class StateAliasingRule(Rule):
    """Shared ``RegistryState`` must be copied before it is stored.

    ``export_state()`` / ``mirror()`` / a delta's ``full`` hand back
    column arrays that alias the producer's live state (zero-copy by
    design). Storing one into long-lived structures — an attribute, a
    history dict — without ``copy_state`` recreates the full-sync
    bug, where the publisher's history and the seeker's mirror were the
    same object and a later heartbeat refresh corrupted shipped deltas.
    Stores and ``adopt_*`` calls of tainted values are flagged unless
    the value flowed through ``copy_state``.
    """

    rule_id = "state-aliasing"
    doc = ("RegistryState from export_state()/mirror()/delta.full must "
           "pass through copy_state before being stored or adopted")
    motivation = "full-sync history/mirror aliasing"
    default_paths = None

    def begin_file(self, ctx: FileContext) -> None:
        self._scopes: List[_AliasScope] = [_AliasScope()]

    @property
    def _scope(self) -> _AliasScope:
        return self._scopes[-1]

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._scopes.append(_AliasScope())
        elif isinstance(node, ast.Assign):
            self._handle_assign(node, ctx)
        elif isinstance(node, ast.Call):
            self._handle_call(node, ctx)

    def leave(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._scopes.pop()

    # -- taint machinery --

    def _is_producer(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Call):
            f = e.func
            if isinstance(f, ast.Attribute) and f.attr in _PRODUCER_METHODS:
                return True
            if isinstance(f, ast.Name) and f.id in _PRODUCER_FUNCS:
                return True
        if isinstance(e, ast.Attribute) and e.attr == "full":
            return True
        return False

    def _is_sanitized(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Call):
            f = e.func
            n = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else None)
            return n in _SANITIZERS
        return False

    def _is_tainted(self, e: ast.AST) -> bool:
        if self._is_sanitized(e):
            return False
        if self._is_producer(e):
            return True
        if isinstance(e, ast.Name):
            return e.id in self._scope.tainted
        if isinstance(e, ast.Subscript) and isinstance(e.value, ast.Name):
            return e.value.id in self._scope.containers
        return False

    def _handle_assign(self, node: ast.Assign, ctx: FileContext) -> None:
        sc = self._scope
        value = node.value
        tainted = self._is_tainted(value)
        for tgt in node.targets:
            for t in (tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]):
                if isinstance(t, ast.Name):
                    if tainted:
                        sc.tainted.add(t.id)
                    else:
                        sc.tainted.discard(t.id)
                        sc.containers.discard(t.id)
                    if any(isinstance(n, ast.Attribute)
                           and isinstance(n.value, ast.Name)
                           and n.value.id == "self"
                           for n in ast.walk(value)):
                        sc.attr_derived.add(t.id)
                    else:
                        sc.attr_derived.discard(t.id)
                elif isinstance(t, ast.Attribute) and tainted:
                    ctx.add(self.rule_id, node,
                            "shared RegistryState stored without "
                            "copy_state (aliases the producer's live "
                            "columns)")
                elif isinstance(t, ast.Subscript) and tainted:
                    base = t.value
                    durable = isinstance(base, ast.Attribute) or (
                        isinstance(base, ast.Name)
                        and base.id in sc.attr_derived)
                    if durable:
                        ctx.add(self.rule_id, node,
                                "shared RegistryState stored without "
                                "copy_state (aliases the producer's live "
                                "columns)")
                    elif isinstance(base, ast.Name):
                        sc.containers.add(base.id)

    def _handle_call(self, node: ast.Call, ctx: FileContext) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _ADOPT_METHODS:
            for arg in node.args:
                if self._is_tainted(arg):
                    ctx.add(self.rule_id, node,
                            f"{f.attr}() fed a shared RegistryState "
                            f"without copy_state")
                    break


# ---------------------------------------------------------------------------
# version-bump (+ the classifier the contract test reuses)
# ---------------------------------------------------------------------------

#: RegistryState / PeerRecord columns whose stores count as mutation
RECORD_FIELDS = frozenset({"trust", "latency_est_ms", "last_heartbeat",
                           "latency_ms", "successes", "failures"})
#: registry attributes holding the record set itself
STATE_ATTRS = frozenset({"_peers", "_pending_state", "_seq"})
_MUTATING_DICT_METHODS = {"pop", "clear", "update", "setdefault",
                          "popitem", "__setitem__"}
_PEERS_ATTRS = {"peers", "_peers"}


@dataclass
class MethodInfo:
    """Mutation classification of one registry method."""

    name: str
    fields: Set[str] = field(default_factory=set)  # record fields touched
    mutates: bool = False
    discharged: bool = False       # bumps a version / calls _touch /
    #                                invalidates a cache in-function
    heartbeat_only: bool = False   # touches nothing but last_heartbeat

    @property
    def violating(self) -> bool:
        return (self.mutates and not self.discharged
                and not self.heartbeat_only and self.name != "__init__")


def _self_attr(node: ast.AST) -> Optional[str]:
    """``attr`` of a ``self.attr`` expression, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def classify_method(fn: ast.FunctionDef) -> MethodInfo:
    """Walk one method and classify its RegistryState mutations.

    A *mutation event* is: a store to a record field (``rec.trust = x``,
    ``m.last_heartbeat[i] = t``), a store/``pop``/``clear`` on the
    records dict (``self._peers`` or a local alias of ``self.peers``),
    or an assignment to ``self._pending_state`` / ``self._seq``. A
    method with events must *discharge* them in the same function by
    calling ``self._touch``, bumping ``self.version``/``topo_version``,
    or invalidating ``self._mirror``/``self._table`` — unless every
    event touches only ``last_heartbeat`` (the deliberate heartbeat
    fast path, which never bumps versions).
    """
    info = MethodInfo(name=fn.name)
    peers_aliases: Set[str] = set()
    events: List[str] = []   # record field ("" = structural)

    def _field_of_target(t: ast.AST) -> Optional[str]:
        # rec.trust = x  /  st.last_heartbeat = col
        if isinstance(t, ast.Attribute) and t.attr in RECORD_FIELDS:
            return t.attr
        # m.last_heartbeat[i] = t  /  m.last_heartbeat[:] = hb
        if (isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Attribute)
                and t.value.attr in RECORD_FIELDS):
            return t.value.attr
        return None

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            targets: List[ast.AST] = []
            for tgt in node.targets:
                targets.extend(tgt.elts if isinstance(tgt, ast.Tuple)
                               else [tgt])
            for t in targets:
                fld = _field_of_target(t)
                if fld is not None:
                    events.append(fld)
                    continue
                attr = _self_attr(t)
                if attr in STATE_ATTRS:
                    events.append("")
                elif attr in {"_mirror", "_table"}:
                    info.discharged = True     # cache invalidation
                if isinstance(t, ast.Subscript):
                    base = t.value
                    if (_self_attr(base) in STATE_ATTRS
                            or _self_attr(base) in _PEERS_ATTRS
                            or (isinstance(base, ast.Name)
                                and base.id in peers_aliases)):
                        events.append("")
                if (isinstance(t, ast.Name)
                        and isinstance(node.value, ast.AST)):
                    src = _self_attr(node.value)
                    if src in _PEERS_ATTRS:
                        peers_aliases.add(t.id)
        elif isinstance(node, ast.AugAssign):
            attr = _self_attr(node.target)
            if attr in {"version", "topo_version"}:
                info.discharged = True
            fld = _field_of_target(node.target)
            if fld is not None:
                events.append(fld)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and (_self_attr(t.value) in STATE_ATTRS
                             or _self_attr(t.value) in _PEERS_ATTRS)):
                    events.append("")
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                if _self_attr(f) == "_touch":
                    info.discharged = True
                elif f.attr in _MUTATING_DICT_METHODS:
                    base = f.value
                    if (_self_attr(base) in STATE_ATTRS
                            or _self_attr(base) in _PEERS_ATTRS
                            or (isinstance(base, ast.Name)
                                and base.id in peers_aliases)):
                        events.append("")
    info.fields = {e for e in events if e}
    info.mutates = bool(events)
    info.heartbeat_only = (info.mutates
                           and all(e == "last_heartbeat" for e in events))
    return info


def classify_registry_class(cls: ast.ClassDef) -> Dict[str, MethodInfo]:
    return {item.name: classify_method(item)
            for item in cls.body
            if isinstance(item, ast.FunctionDef)}


class VersionBumpRule(Rule):
    """Registry mutators must bump a version or invalidate a cache.

    ``AnchorRegistry.version`` is the cache key for snapshots, plans,
    and digests — a mutator that forgets ``_touch()`` silently serves
    stale tables. The test suite's dynamic contract test exercises each
    mutator; this rule closes the other half of the loop by proving,
    statically, that every mutating method discharges its mutation in
    the same function (heartbeat-only methods are exempt by design:
    liveness deliberately never bumps versions).
    """

    rule_id = "version-bump"
    doc = ("registry methods mutating RegistryState must bump "
           "version/seq or invalidate a cache in the same function")
    motivation = "snapshot-versioning contract; hand-kept mutator "\
                 "list in test_sharded_registry"
    default_paths = None

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if not isinstance(node, ast.ClassDef):
            return
        classes = self.options.get("registry_classes", ["AnchorRegistry"])
        if node.name not in classes:
            return
        for item in node.body:
            if not isinstance(item, ast.FunctionDef):
                continue
            info = classify_method(item)
            if info.violating:
                fields = ", ".join(sorted(info.fields)) or "records"
                ctx.add(self.rule_id, item,
                        f"{node.name}.{item.name} mutates {fields} but "
                        f"never bumps version/topo_version, calls "
                        f"_touch(), or invalidates _mirror/_table",
                        symbol=f"{ctx.qualname}.{item.name}")


# ---------------------------------------------------------------------------
# tracer-guard
# ---------------------------------------------------------------------------

_SPAN_METHODS = {"span", "begin", "end", "event", "add"}
_TRACER_NAMES = {"tr", "tracer"}


@dataclass
class _GuardScope:
    tracer_aliases: Set[str] = field(default_factory=set)  # tr = self.tracer
    guard_aliases: Set[str] = field(default_factory=set)   # traced = tr.enabled
    span_aliases: Set[str] = field(default_factory=set)    # sp = ... if en else None


class TracerGuardRule(Rule):
    """Span creation outside ``obs/`` must be behind ``tracer.enabled``.

    The tracing plane keeps the disabled-tracer hot path at ~zero
    cost by guarding every span/event call site (``if tracer.enabled:``
    or the ``sp = tr.begin(...) if tr.enabled else None`` no-op
    pattern). An unguarded call site pays dict/list work per request
    even with tracing off — and regresses exactly the hot paths
    (routing, hedging, serving) the guards were added for.
    """

    rule_id = "tracer-guard"
    doc = ("tracer span/event calls outside obs/ must be gated on "
           "tracer.enabled (or the NOOP/span-is-None pattern)")
    motivation = "hot-path guard discipline"
    default_paths = ("src/repro_torch/",)

    def applies_to(self, path: str) -> bool:
        if not super().applies_to(path):
            return False
        return "/obs/" not in path

    def begin_file(self, ctx: FileContext) -> None:
        self._scopes: List[_GuardScope] = [_GuardScope()]

    @property
    def _scope(self) -> _GuardScope:
        return self._scopes[-1]

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._scopes.append(_GuardScope())
        elif isinstance(node, ast.Assign):
            self._track_assign(node)
        elif isinstance(node, ast.Call):
            self._check_call(node, ctx)

    def leave(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._scopes.pop()

    def _track_assign(self, node: ast.Assign) -> None:
        sc = self._scope
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if not names:
            return
        v = node.value
        if any(isinstance(n, ast.Attribute) and n.attr == "tracer"
               for n in ast.walk(v)) and not isinstance(v, ast.Call):
            sc.tracer_aliases.update(names)
        if any(isinstance(n, ast.Attribute) and n.attr == "enabled"
               for n in ast.walk(v)) and not isinstance(v, ast.Call):
            sc.guard_aliases.update(names)
        if isinstance(v, ast.IfExp) and self._is_guard_expr(v.test):
            sc.span_aliases.update(names)   # sp = begin() if enabled else None

    def _is_tracer_receiver(self, recv: ast.AST) -> bool:
        if isinstance(recv, ast.Attribute) and recv.attr == "tracer":
            return True
        if isinstance(recv, ast.Name):
            return (recv.id in self._scope.tracer_aliases
                    or recv.id in _TRACER_NAMES)
        return False

    def _is_guard_expr(self, test: ast.AST) -> bool:
        sc = self._scope
        if isinstance(test, ast.Attribute) and test.attr == "enabled":
            return True
        if isinstance(test, ast.Name) and test.id in sc.guard_aliases:
            return True
        if (isinstance(test, ast.Compare)
                and isinstance(test.left, ast.Name)
                and test.left.id in sc.span_aliases
                and len(test.ops) == 1
                and isinstance(test.ops[0], (ast.IsNot, ast.Is))):
            return True
        if isinstance(test, ast.BoolOp):
            return any(self._is_guard_expr(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._is_guard_expr(test.operand)
        return False

    def _is_guarded(self, ctx: FileContext) -> bool:
        stack = ctx.stack
        for parent, child in zip(stack[:-1], stack[1:]):
            if isinstance(parent, ast.If):
                in_body = any(child is s for s in parent.body)
                in_orelse = any(child is s for s in parent.orelse)
                if (in_body or in_orelse) and self._is_guard_expr(
                        parent.test):
                    return True
            elif isinstance(parent, ast.IfExp):
                if child is parent.body and self._is_guard_expr(parent.test):
                    return True
            elif isinstance(parent, ast.BoolOp) and isinstance(
                    parent.op, ast.And):
                idx = next((i for i, v in enumerate(parent.values)
                            if v is child), None)
                if idx and any(self._is_guard_expr(v)
                               for v in parent.values[:idx]):
                    return True
        return False

    def _check_call(self, node: ast.Call, ctx: FileContext) -> None:
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr in _SPAN_METHODS):
            return
        if not self._is_tracer_receiver(f.value):
            return
        if self._is_guarded(ctx):
            return
        recv = dotted_name(f.value) or "tracer"
        ctx.add(self.rule_id, node,
                f"unguarded tracer call {recv}.{f.attr}(...) on a hot "
                f"path; gate on tracer.enabled or the span-is-None "
                f"pattern")


# ---------------------------------------------------------------------------
# wire-safety
# ---------------------------------------------------------------------------

_POST_METHODS = {"post", "put", "put_nowait", "send"}


class WireSafetyRule(Rule):
    """Control-plane RPC payloads must be plain picklable messages.

    Everything posted to a worker queue crosses a process boundary
    (``mp.Queue``) or a pickle round-trip (``LoopbackTransport``), so a
    lambda, generator, or locally-defined function/class in a payload
    either fails to pickle or — worse — pickles by reference and
    desynchronizes the worker. Payloads stay in the fixed
    ``(req_id, op, args)`` tuple vocabulary of plain data.
    """

    rule_id = "wire-safety"
    doc = ("no lambdas/generators/locally-defined objects in "
           "control-plane queue payloads")
    motivation = "worker-per-shard RPC plane (pickled transport)"
    default_paths = ("src/repro_torch/control_plane/",)

    def begin_file(self, ctx: FileContext) -> None:
        self._local_defs: List[Set[str]] = [set()]
        self._recent: List[Dict[str, ast.AST]] = [{}]

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # the def itself is a local object in the *enclosing* scope
            if len(self._local_defs) > 1 or ctx.scope_function() is not None:
                self._local_defs[-1].add(node.name)
            self._local_defs.append(set())
            self._recent.append({})
        elif isinstance(node, ast.ClassDef):
            if ctx.scope_function() is not None:
                self._local_defs[-1].add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._recent[-1][t.id] = node.value
            if isinstance(node.value, ast.Lambda):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self._local_defs[-1].add(t.id)
        elif isinstance(node, ast.Call):
            self._check_call(node, ctx)

    def leave(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._local_defs.pop()
            self._recent.pop()

    def _hazard(self, e: ast.AST) -> Optional[str]:
        for n in ast.walk(e):
            if isinstance(n, ast.Lambda):
                return "a lambda"
            if isinstance(n, ast.GeneratorExp):
                return "a generator expression"
            if (isinstance(n, ast.Name)
                    and n.id in self._local_defs[-1]):
                return f"locally-defined object {n.id!r}"
        return None

    def _check_call(self, node: ast.Call, ctx: FileContext) -> None:
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr in _POST_METHODS):
            return
        for arg in node.args:
            expr = arg
            if isinstance(arg, ast.Name):
                expr = self._recent[-1].get(arg.id, arg)
            hazard = self._hazard(expr)
            if hazard is not None:
                ctx.add(self.rule_id, node,
                        f"RPC payload contains {hazard}; control-plane "
                        f"messages must be plain picklable data "
                        f"(req_id, op, args)")
                return


ALL_RULES: Tuple[type, ...] = (
    ClockDisciplineRule, RngDisciplineRule, StateAliasingRule,
    VersionBumpRule, TracerGuardRule, WireSafetyRule,
)


def build_rules(options: Optional[Dict[str, dict]] = None) -> List[Rule]:
    options = options or {}
    return [cls(options.get(cls.rule_id)) for cls in ALL_RULES]
