"""Single-pass AST invariant linter for the PyTorch port.

Port of ``repro.analysis.core``, the same framework verbatim: every hard
bug the reproduction has shipped-then-fixed was an *invariant* violation,
not a logic error: full-sync state aliasing, a back-dated ``maybe_tick``
clock, the one-RNG-draw-per-hop determinism contract, the clock-domain
split and ``tracer.enabled`` hot-path guards. Generic linters cannot see
any of them; this framework mechanizes them as repo-specific AST rules so
the conventions cannot silently regress in the port either.

Architecture:

* ``Rule`` — pluggable rule class. Each rule registers for the node
  events it cares about; the ``Walker`` traverses each module's AST
  exactly once and dispatches every node (in document order) to every
  applicable rule, so N rules cost one pass.
* ``FileContext`` — what a rule sees: the ancestor stack, the current
  class/function qualname, and ``add()`` to report a finding.
* allow-list — ``repolint_torch.json`` at the repo root maps (rule,
  path[, symbol]) to a *justification string*; allowed findings are
  printed with their justification but do not fail the run. Unused
  entries DO fail the run (stale allows hide regressions). The port
  keeps its own file: the reference's ``repolint.json`` is never read.
* inline suppressions — ``# repolint: allow[<rule-id>]`` on the flagged
  line (or alone on the line above) suppresses one rule there; a
  suppression that matches nothing is itself a finding.
* output — human ``path:line:col rule message`` lines or ``--json``;
  exit 0 clean, 1 findings, 2 usage/config error.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

SCHEMA_VERSION = 1

#: pseudo-rules emitted by the framework itself
PARSE_ERROR = "parse-error"
UNUSED_SUPPRESSION = "unused-suppression"
UNUSED_ALLOW = "unused-allow"

_SUPPRESS_RE = re.compile(r"#\s*repolint:\s*allow\[([a-z0-9,\-\s]+)\]")


class ConfigError(Exception):
    """Bad config / usage — exit code 2, never a finding."""


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str         # repo-relative posix path
    line: int
    col: int
    message: str
    symbol: str = ""  # enclosing qualname ("" at module level)

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "symbol": self.symbol}

    def render(self) -> str:
        where = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}: {self.message}{where}")


@dataclass
class AllowEntry:
    """One checked-in allow-list entry. ``symbol`` narrows the entry to
    a qualname (exact match); without it the whole file is covered for
    that rule. ``why`` is mandatory — the printed justification is the
    point of the mechanism."""

    rule: str
    path: str
    why: str
    symbol: Optional[str] = None
    hits: int = 0

    def matches(self, f: Finding) -> bool:
        if f.rule != self.rule or f.path != self.path:
            return False
        return self.symbol is None or self.symbol == f.symbol


@dataclass
class Config:
    """Parsed ``repolint_torch.json``: allow entries + per-rule options."""

    allow: List[AllowEntry] = field(default_factory=list)
    options: Dict[str, dict] = field(default_factory=dict)
    source: str = "<none>"

    def rule_options(self, rule_id: str) -> dict:
        return self.options.get(rule_id, {})


def load_config(path: str, known_rules: Iterable[str]) -> Config:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            raw = json.load(fh)
    except OSError as e:
        raise ConfigError(f"cannot read config {path}: {e}")
    except ValueError as e:
        raise ConfigError(f"config {path} is not valid JSON: {e}")
    if not isinstance(raw, dict):
        raise ConfigError(f"config {path}: top level must be an object")
    known = set(known_rules)
    entries: List[AllowEntry] = []
    for i, item in enumerate(raw.get("allow", [])):
        if not isinstance(item, dict):
            raise ConfigError(f"config {path}: allow[{i}] must be an object")
        missing = {"rule", "path", "why"} - set(item)
        if missing:
            raise ConfigError(f"config {path}: allow[{i}] missing "
                              f"{sorted(missing)}")
        if item["rule"] not in known:
            raise ConfigError(f"config {path}: allow[{i}] names unknown "
                              f"rule {item['rule']!r}")
        if not str(item["why"]).strip():
            raise ConfigError(f"config {path}: allow[{i}] has an empty "
                              f"justification")
        entries.append(AllowEntry(rule=item["rule"],
                                  path=str(item["path"]),
                                  why=str(item["why"]),
                                  symbol=item.get("symbol")))
    options = raw.get("rules", {})
    if not isinstance(options, dict):
        raise ConfigError(f"config {path}: 'rules' must be an object")
    for rid in options:
        if rid not in known:
            raise ConfigError(f"config {path}: options for unknown rule "
                              f"{rid!r}")
    return Config(allow=entries, options=options, source=path)


#: the port's allow-list file, found at the repo root
CONFIG_NAME = "repolint_torch.json"


def find_config(start: str = ".") -> Optional[str]:
    """Nearest ``repolint_torch.json`` from ``start`` upward (repo-root
    discovery for runs from subdirectories)."""
    d = os.path.abspath(start)
    while True:
        cand = os.path.join(d, CONFIG_NAME)
        if os.path.isfile(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------


@dataclass
class Suppression:
    line: int            # line the comment sits on
    covers: int          # line whose findings it suppresses
    rules: Tuple[str, ...]
    used: bool = False


def scan_suppressions(source_lines: Sequence[str]) -> List[Suppression]:
    """``repolint: allow[<rule-id>]`` comment markers. A marker sharing
    its line with code covers that line; a comment-only line covers the
    next."""
    out: List[Suppression] = []
    for i, text in enumerate(source_lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        comment_only = text.lstrip().startswith("#")
        out.append(Suppression(line=i, covers=i + 1 if comment_only else i,
                               rules=rules))
    return out


# ---------------------------------------------------------------------------
# Visitor core
# ---------------------------------------------------------------------------


class FileContext:
    """Per-file state shared by every rule during the single pass."""

    def __init__(self, path: str, tree: ast.Module,
                 source_lines: Sequence[str]):
        self.path = path
        self.tree = tree
        self.source_lines = source_lines
        self.stack: List[ast.AST] = []       # ancestors, root first
        self._names: List[str] = []          # class/function name stack
        self.findings: List[Finding] = []

    @property
    def qualname(self) -> str:
        return ".".join(self._names)

    def scope_function(self) -> Optional[ast.AST]:
        """Innermost enclosing function def, if any."""
        for node in reversed(self.stack):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return node
        return None

    def add(self, rule_id: str, node: ast.AST, message: str,
            symbol: Optional[str] = None) -> None:
        self.findings.append(Finding(
            rule=rule_id, path=self.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=message,
            symbol=self.qualname if symbol is None else symbol))


class Rule:
    """Base rule. Subclasses set ``rule_id``/``doc``/``motivation`` and
    implement ``visit`` (every node, document order) and optionally
    ``begin_file`` / ``leave`` / ``end_file``. ``default_paths`` scopes
    the rule to path prefixes; the config's ``paths`` option for the
    rule overrides it. ``None`` means every analyzed file."""

    rule_id: str = ""
    doc: str = ""          # the invariant, one line
    motivation: str = ""   # the PR / bug class that created it
    default_paths: Optional[Tuple[str, ...]] = None

    def __init__(self, options: Optional[dict] = None):
        self.options = dict(options or {})

    def paths(self) -> Optional[Tuple[str, ...]]:
        paths = self.options.get("paths")
        if paths is not None:
            return tuple(paths)
        return self.default_paths

    def applies_to(self, path: str) -> bool:
        prefixes = self.paths()
        if prefixes is None:
            return True
        return any(path.startswith(p) for p in prefixes)

    def begin_file(self, ctx: FileContext) -> None:  # pragma: no cover
        pass

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        raise NotImplementedError

    def leave(self, node: ast.AST, ctx: FileContext) -> None:
        pass

    def end_file(self, ctx: FileContext) -> None:
        pass


class Walker:
    """One traversal, N rules: every node is offered to every rule in
    document order; ``leave`` fires after a node's subtree (rules use it
    to close per-function/per-class analyses)."""

    def __init__(self, rules: Sequence[Rule]):
        self.rules = list(rules)

    def run(self, ctx: FileContext) -> None:
        active = [r for r in self.rules if r.applies_to(ctx.path)]
        if not active:
            return
        for r in active:
            r.begin_file(ctx)
        self._walk(ctx.tree, ctx, active)
        for r in active:
            r.end_file(ctx)

    def _walk(self, node: ast.AST, ctx: FileContext,
              rules: Sequence[Rule]) -> None:
        named = isinstance(node, (ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef))
        if named:
            ctx._names.append(node.name)
        ctx.stack.append(node)
        for r in rules:
            r.visit(node, ctx)
        for child in ast.iter_child_nodes(node):
            self._walk(child, ctx, rules)
        for r in rules:
            r.leave(node, ctx)
        ctx.stack.pop()
        if named:
            ctx._names.pop()


# ---------------------------------------------------------------------------
# Shared AST helpers (used by several rules)
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for nested Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_attr(node: ast.AST) -> Optional[str]:
    """The attribute name of an ``x.y(...)`` call, else None."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def contains(tree: ast.AST, pred) -> bool:
    return any(pred(n) for n in ast.walk(tree))


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


@dataclass
class FileReport:
    path: str
    findings: List[Finding] = field(default_factory=list)
    allowed: List[Tuple[Finding, str]] = field(default_factory=list)
    suppressed: int = 0


@dataclass
class RunReport:
    reports: List[FileReport] = field(default_factory=list)
    config: Config = field(default_factory=Config)
    files: int = 0

    @property
    def findings(self) -> List[Finding]:
        return [f for r in self.reports for f in r.findings]

    @property
    def allowed(self) -> List[Tuple[Finding, str]]:
        return [a for r in self.reports for a in r.allowed]

    def to_json(self) -> dict:
        return {
            "version": SCHEMA_VERSION,
            "config": self.config.source,
            "files": self.files,
            "findings": [f.to_json() for f in self.findings],
            "allowed": [dict(f.to_json(), why=why)
                        for f, why in self.allowed],
            "summary": {"findings": len(self.findings),
                        "allowed": len(self.allowed)},
        }


def _iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d != "__pycache__"
                                 and not d.startswith("."))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        else:
            raise ConfigError(f"no such path: {p}")
    return out


def _norm(path: str) -> str:
    return os.path.relpath(path).replace(os.sep, "/")


def analyze_file(path: str, rules: Sequence[Rule]) -> FileReport:
    """Lint one file: parse, single-pass walk, then fold suppressions
    (and count the unused ones as findings)."""
    rel = _norm(path)
    report = FileReport(path=rel)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        report.findings.append(Finding(
            rule=PARSE_ERROR, path=rel, line=e.lineno or 0,
            col=e.offset or 0, message=f"syntax error: {e.msg}"))
        return report
    except OSError as e:
        raise ConfigError(f"cannot read {path}: {e}")
    lines = source.splitlines()
    ctx = FileContext(rel, tree, lines)
    Walker(rules).run(ctx)
    supps = scan_suppressions(lines)
    by_line: Dict[int, List[Suppression]] = {}
    for s in supps:
        by_line.setdefault(s.covers, []).append(s)
    for f in ctx.findings:
        hit = None
        for s in by_line.get(f.line, ()):
            if f.rule in s.rules:
                hit = s
                break
        if hit is not None:
            hit.used = True
            report.suppressed += 1
        else:
            report.findings.append(f)
    known = {r.rule_id for r in rules}
    for s in supps:
        for rid in s.rules:
            if rid not in known:
                report.findings.append(Finding(
                    rule=UNUSED_SUPPRESSION, path=rel, line=s.line, col=0,
                    message=f"suppression names unknown rule {rid!r}"))
        if not s.used and all(rid in known for rid in s.rules):
            report.findings.append(Finding(
                rule=UNUSED_SUPPRESSION, path=rel, line=s.line, col=0,
                message=("suppression matches no finding: "
                         f"allow[{','.join(s.rules)}]")))
    return report


def analyze_paths(paths: Sequence[str], rules: Sequence[Rule],
                  config: Config) -> RunReport:
    """Lint a path set under a config: findings that match an allow
    entry move to the 'allowed' bucket (justification attached); allow
    entries whose file was analyzed but never matched become
    ``unused-allow`` findings."""
    run = RunReport(config=config)
    analyzed: Set[str] = set()
    for path in _iter_py_files(paths):
        rep = analyze_file(path, rules)
        analyzed.add(rep.path)
        kept: List[Finding] = []
        for f in rep.findings:
            entry = next((e for e in config.allow if e.matches(f)), None)
            if entry is not None:
                entry.hits += 1
                rep.allowed.append((f, entry.why))
            else:
                kept.append(f)
        rep.findings = kept
        run.reports.append(rep)
        run.files += 1
    for e in config.allow:
        if e.hits == 0 and e.path in analyzed:
            sym = f" symbol={e.symbol}" if e.symbol else ""
            run.reports.append(FileReport(
                path=e.path,
                findings=[Finding(
                    rule=UNUSED_ALLOW, path=e.path, line=0, col=0,
                    message=(f"allow-list entry matched nothing: "
                             f"rule={e.rule}{sym} — delete it or fix the "
                             f"config"))]))
    return run
