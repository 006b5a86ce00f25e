"""The port's linter (``repro_torch.analysis``) held against the
reference's (``repro.analysis``).

* Every source the reference's own tests lint (``tests/test_analysis.py``:
  each case that calls ``findings_in``, each parameter, and the
  suppression snippets) goes through both linters, the port's at the
  path moved from ``src/repro/`` to ``src/repro_torch/``: the same
  (rule, line, col, message, symbol), finding for finding.
* Both CLIs: ``--json`` keys, exit codes, ``--list-rules``; the port reads
  ``repolint_torch.json`` and never the reference's ``repolint.json``.
* ``--no-config`` over ``src/repro`` and over ``src/repro_torch``: the same
  findings, counted by (rule, path in the package, symbol).
* The live port tree under ``repolint_torch.json``: 0 findings, 26
  allowed, no unused entry.
* ``rng-discipline`` on torch's process-global generator.
* The version-bump contract (``tests/test_sharded_registry.py``'s) on the
  port's registry: the derived mutator set equals the reference's, and
  each scenario bumps the version vector, or leaves it alone, as the
  reference's does.
"""
import ast
import collections
import importlib
import json
import re
import textwrap
from pathlib import Path

import numpy as np
import pytest

import repro.analysis as ref
import repro_torch.analysis as port
from repro_torch.analysis.core import FileContext, Walker

ROOT = Path(__file__).resolve().parents[1]
REF_TESTS = ROOT / "tests" / "test_analysis.py"


def _key(findings):
    return [(f.rule, f.line, f.col, f.message, f.symbol) for f in findings]


def _port_path(path):
    assert path.startswith("src/repro/"), path
    return "src/repro_torch/" + path[len("src/repro/"):]


def port_findings_in(src, path, options=None):
    """The reference test's ``findings_in`` on the port's rules."""
    src = textwrap.dedent(src)
    ctx = FileContext(path, ast.parse(src), src.splitlines())
    Walker(port.build_rules(options)).run(ctx)
    return ctx.findings


def _reference_cases():
    """(class, method, params) of every test in ``tests/test_analysis.py``
    that lints a source through ``findings_in``, once per parameter."""
    tree = ast.parse(REF_TESTS.read_text())
    out = []

    def calls_findings_in(fn):
        return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                   and n.func.id == "findings_in" for n in ast.walk(fn))

    def params(fn):
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Call) and \
                    getattr(dec.func, "attr", "") == "parametrize":
                name = ast.literal_eval(dec.args[0])
                return [{name: v} for v in ast.literal_eval(dec.args[1])]
        return [{}]

    for node in tree.body:
        fns = ([(node.name, f) for f in node.body
                if isinstance(f, ast.FunctionDef)]
               if isinstance(node, ast.ClassDef) else
               [(None, node)] if isinstance(node, ast.FunctionDef) else [])
        for cls, fn in fns:
            if fn.name.startswith("test_") and calls_findings_in(fn):
                out.extend((cls, fn.name, p) for p in params(fn))
    return out


CASES = _reference_cases()


def test_reference_cases_found():
    """Every rule's fixture class of the reference's tests is covered."""
    classes = {c for c, _, _ in CASES}
    assert {"TestClockDiscipline", "TestRngDiscipline", "TestStateAliasing",
            "TestVersionBump", "TestTracerGuard",
            "TestWireSafety"} <= classes
    assert len(CASES) >= 30


@pytest.mark.parametrize(
    "cls,name,params", CASES,
    ids=[f"{c}.{n}" + "".join(f"[{v}]" for v in p.values())
         for c, n, p in CASES])
def test_same_findings_on_reference_sources(monkeypatch, cls, name, params):
    """The reference's test runs as written, each ``findings_in`` call
    through both linters: the findings must be identical (the reference
    test's own assertions then hold for the port's too)."""
    mod = importlib.import_module("test_analysis")
    orig = mod.findings_in
    seen = []

    def both(src, path="src/repro/serving/snippet.py", options=None):
        want = orig(src, path=path, options=options)
        got = port_findings_in(src, _port_path(path), options)
        assert _key(got) == _key(want), (path, src)
        seen.append(path)
        return want

    monkeypatch.setattr(mod, "findings_in", both)
    owner = getattr(mod, cls)() if cls else mod
    getattr(owner, name)(**params)
    assert seen


_RNG_SNIPPET = textwrap.dedent("""
    import numpy as np

    def pick(xs):
        rng = np.random.default_rng(){}
        return xs[rng.integers(len(xs))]
""")
SUPPRESSION_BODIES = {
    "inline": _RNG_SNIPPET.format("  # repolint: allow[rng-discipline]"),
    "line_above": _RNG_SNIPPET.format("").replace(
        "    rng =", "    # repolint: allow[rng-discipline]\n    rng ="),
    "none": _RNG_SNIPPET.format(""),
    "unused": "x = 1  # repolint: allow[rng-discipline]\n",
    "unknown_rule": "x = 1  # repolint: allow[no-such-rule]\n",
}


@pytest.mark.parametrize("body", list(SUPPRESSION_BODIES))
def test_same_suppressions_on_reference_snippets(tmp_path, monkeypatch,
                                                 body):
    """The reference tests' suppression snippets through both linters'
    ``analyze_file``: the same findings and the same suppressed count."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "snippet.py").write_text(SUPPRESSION_BODIES[body])
    want = ref.analyze_file("snippet.py", ref.build_rules())
    got = port.analyze_file("snippet.py", port.build_rules())
    assert _key(got.findings) == _key(want.findings)
    assert got.suppressed == want.suppressed


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _mains():
    from repro.analysis.__main__ import main as ref_main
    from repro_torch.analysis.__main__ import main as port_main
    return ref_main, port_main


def test_cli_json_schema_matches_reference(tmp_path, monkeypatch, capsys):
    """``--json --no-config``: the same keys, finding keys, finding and
    summary, exit 1, from both CLIs."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "snip.py").write_text(_RNG_SNIPPET.format(""))
    outs = []
    for main in _mains():
        assert main(["--json", "--no-config", "snip.py"]) == 1
        outs.append(json.loads(capsys.readouterr().out))
    want, got = outs
    assert set(got) == set(want) == {"version", "config", "files",
                                     "findings", "allowed", "summary"}
    assert got == want
    (f,) = got["findings"]
    assert f["rule"] == "rng-discipline" and f["symbol"] == "pick"
    assert got["summary"] == {"findings": 1, "allowed": 0}


def test_cli_exit_codes_and_config_file(tmp_path, monkeypatch, capsys):
    """0 clean, 2 for a missing path or a broken config, 1 for findings;
    the port reads ``repolint_torch.json`` and ignores a ``repolint.json``
    (which the reference's CLI reads)."""
    ref_main, port_main = _mains()
    monkeypatch.chdir(tmp_path)
    (tmp_path / "clean.py").write_text("x = 1\n")
    for main in (ref_main, port_main):
        assert main(["--no-config", "clean.py"]) == 0
        assert main(["--no-config", "missing.py"]) == 2
    (tmp_path / "repolint.json").write_text("{not json")
    assert ref_main(["clean.py"]) == 2
    assert port_main(["clean.py"]) == 0
    (tmp_path / "repolint_torch.json").write_text("{not json")
    assert port_main(["clean.py"]) == 2
    (tmp_path / "repolint_torch.json").write_text(json.dumps(
        {"allow": [{"rule": "rng-discipline", "path": "snip.py",
                    "why": "fixture: deliberate"}]}))
    (tmp_path / "snip.py").write_text(_RNG_SNIPPET.format(""))
    assert port_main(["snip.py"]) == 0
    assert port_main(["clean.py"]) == 0      # entry's file not analyzed
    assert port_main(["--no-config", "snip.py"]) == 1
    assert port.find_config(str(tmp_path)) == str(
        tmp_path / "repolint_torch.json")
    capsys.readouterr()


def test_cli_list_rules_matches_reference(capsys):
    """The same six rules in the same order with the same one-line
    invariants."""
    outs = []
    for main in _mains():
        assert main(["--list-rules"]) == 0
        outs.append(capsys.readouterr().out.splitlines())
    want, got = outs
    assert got[0::2] == want[0::2]
    assert [r.rule_id for r in port.ALL_RULES] == \
        [r.rule_id for r in ref.ALL_RULES]


# ---------------------------------------------------------------------------
# The two trees
# ---------------------------------------------------------------------------


def test_no_config_findings_match_reference_tree(monkeypatch):
    """``--no-config`` over ``src/repro`` and over ``src/repro_torch``: the
    same findings counted by (rule, path in the package, symbol): the 18
    clock-discipline, 6 state-aliasing and 2 tracer-guard sites the
    allow-lists name."""
    monkeypatch.chdir(ROOT)

    def count(run, prefix):
        return collections.Counter((f.rule, f.path[len(prefix):], f.symbol)
                                   for f in run.findings)

    want = count(ref.analyze_paths(["src/repro"], ref.build_rules(),
                                   ref.Config()), "src/repro/")
    got = count(port.analyze_paths(["src/repro_torch"], port.build_rules(),
                                   port.Config()), "src/repro_torch/")
    assert got == want
    by_rule = collections.Counter()
    for (rule, _, _), n in got.items():
        by_rule[rule] += n
    assert by_rule == {"clock-discipline": 18, "state-aliasing": 6,
                       "tracer-guard": 2}


def test_live_port_tree_is_clean_under_its_allowlist(monkeypatch, capsys):
    """``python -m repro_torch.analysis`` from the repo root: exit 0,
    "0 finding(s), 26 allowed", every allow entry used; the entries are
    the reference's (rule, path moved, symbol, options), each with the
    reference entry's justification (two reworded where it names the
    reference's change numbers)."""
    _, port_main = _mains()
    monkeypatch.chdir(ROOT)
    assert port_main([]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1].endswith("0 finding(s), 26 allowed")
    assert port_main(["--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["summary"] == {"findings": 0, "allowed": 26}
    assert rep["config"].endswith("repolint_torch.json")
    known = [r.rule_id for r in port.build_rules()]
    cfg = port.load_config(str(ROOT / "repolint_torch.json"), known)
    want = ref.load_config(str(ROOT / "repolint.json"), known)
    assert [(e.rule, e.path, e.symbol) for e in cfg.allow] == \
        [(e.rule, _port_path(e.path), e.symbol) for e in want.allow]
    numbered = re.compile(r"\bPR \d")
    assert all(e.why == w.why for e, w in zip(cfg.allow, want.allow)
               if not numbered.search(w.why))
    assert not any(numbered.search(e.why) for e in cfg.allow)
    assert cfg.options == want.options
    run = port.analyze_paths(["src/repro_torch"],
                             port.build_rules(cfg.options), cfg)
    assert all(e.hits > 0 for e in cfg.allow)
    assert len(run.allowed) == 26 and not run.findings


# ---------------------------------------------------------------------------
# rng-discipline on torch's global generator
# ---------------------------------------------------------------------------

TORCH_FLAGGED = {
    "manual_seed": "torch.manual_seed(0)",
    "cuda_manual_seed_all": "torch.cuda.manual_seed_all(0)",
    "seed": "torch.seed()",
    "rand": "torch.rand(3)",
    "randn": "torch.randn(2, 3, device='cpu')",
    "randint": "torch.randint(0, 5, (3,))",
    "randperm": "torch.randperm(4)",
    "normal": "torch.normal(0.0, 1.0, (3,))",
    "bernoulli": "torch.bernoulli(p)",
    "multinomial": "torch.multinomial(p, 1)",
    "alias": "T.randn(3)",
    "from_import": "rn(3)",
    "from_import_seed": "ms(0)",
}
TORCH_CLEAN = {
    "randn_generator": "torch.randn(3, generator=g)",
    "multinomial_generator": "torch.multinomial(p, 1, generator=g)",
    "seeded_generator": "torch.Generator(device='cpu').manual_seed(0)",
    "generator_method": "g.manual_seed(0)",
    "like": "torch.randn_like(p)",
    "from_import_generator": "rn(3, generator=g)",
}
_TORCH_SRC = """
    import torch
    import torch as T
    from torch import randn as rn, manual_seed as ms

    def draw(p, g):
        return {}
"""


@pytest.mark.parametrize("case", list(TORCH_FLAGGED))
def test_torch_global_generator_is_flagged(case):
    fs = port_findings_in(_TORCH_SRC.format(TORCH_FLAGGED[case]),
                          "src/repro_torch/models/x.py")
    assert [f.rule for f in fs] == ["rng-discipline"], fs
    assert fs[0].symbol == "draw" and fs[0].line == 7
    assert "generator" in fs[0].message
    # the reference's rule has nothing to say here (JAX has no global
    # generator)
    want = ref.build_rules()
    ctx = FileContext("src/repro/models/x.py", ast.parse(textwrap.dedent(
        _TORCH_SRC.format(TORCH_FLAGGED[case]))), [])
    Walker(want).run(ctx)
    assert ctx.findings == []


@pytest.mark.parametrize("case", list(TORCH_CLEAN))
def test_passed_torch_generator_is_clean(case):
    assert port_findings_in(_TORCH_SRC.format(TORCH_CLEAN[case]),
                            "src/repro_torch/models/x.py") == []


# The wall slot (``obs.trace.wall``) is a tracer receiver: its spans in
# the models and the serving loops are held to the same guard.
WALL_FLAGGED = {
    "direct_call": """
        def block(x):
            with wall().span("model.attn"):
                return x
    """,
    "alias": """
        def block(x):
            wtr = wall()
            with wtr.span("model.attn"):
                return x
    """,
    "module_attribute": """
        from repro_torch.obs import trace

        def block(x):
            t = trace.wall()
            sp = t.begin("model.attn")
            t.end(sp)
            return x
    """,
}
WALL_CLEAN = {
    "enabled_guard": """
        def block(x):
            tr = wall()
            with tr.span("model.attn") if tr.enabled else NOOP_SPAN:
                return x
    """,
    "alias_guard": """
        def block(x):
            wtr = wall()
            with wtr.span("loop.window") if wtr.enabled else NOOP_SPAN:
                return x
    """,
    "span_is_none": """
        def block(x):
            t = wall()
            sp = t.begin("model.attn") if t.enabled else None
            if sp is not None:
                t.end(sp)
            return x
    """,
    "other_call": """
        def block(x, clock):
            w = clock()
            w.span("not a tracer")
            return x
    """,
}


@pytest.mark.parametrize("case", list(WALL_FLAGGED))
def test_unguarded_wall_span_is_flagged(case):
    fs = port_findings_in(WALL_FLAGGED[case], "src/repro_torch/models/x.py")
    assert fs and {f.rule for f in fs} == {"tracer-guard"}, fs
    assert all(f.symbol == "block" for f in fs)


@pytest.mark.parametrize("case", list(WALL_CLEAN))
def test_guarded_wall_span_is_clean(case):
    assert port_findings_in(WALL_CLEAN[case],
                            "src/repro_torch/serving/x.py") == []


# ---------------------------------------------------------------------------
# The version-bump contract on the port's registry
# ---------------------------------------------------------------------------


def test_derived_mutators_match_reference():
    """The port's derived mutator set and each method's classification
    (fields, mutates, discharged, heartbeat-only) equal the reference's."""
    assert port.registry_mutators() == ref.registry_mutators()
    want, got = ref.registry_mutator_info(), port.registry_mutator_info()
    assert set(got) == set(want)
    for name, info in got.items():
        w = want[name]
        assert (info.fields, info.mutates, info.discharged,
                info.heartbeat_only) == (w.fields, w.mutates, w.discharged,
                                         w.heartbeat_only), name


def _scenarios(types):
    """``tests/test_sharded_registry.py``'s MUTATOR_SCENARIOS, built on
    ``types`` (either package's ``core.types``)."""
    ER, HR = types.ExecReport, types.HopReport

    def adopt_heartbeats(r, now):
        target = r if not hasattr(r, "shards") else r.shards[0]
        target.adopt_heartbeats(target.export_heartbeats() + 1.0)

    return {
        "set_trust": [
            ("set_trust", lambda r, now: r.set_trust(0, 0.42), True),
            ("set_trust_unknown", lambda r, now: r.set_trust(9_999, 0.42),
             False)],
        "reset_trust": [("reset_trust", lambda r, now: r.reset_trust(),
                         True)],
        "apply_report": [
            ("apply_report_success", lambda r, now: r.apply_report(
                ER(True, [0, 5], [HR(p, 40.0, True) for p in (0, 5)])),
             True),
            ("apply_report_failure", lambda r, now: r.apply_report(
                ER(False, [3], [HR(3, 200.0, False)], failed_peer=3)), True),
            ("apply_report_unknown_peers", lambda r, now: r.apply_report(
                ER(True, [9_999], [HR(9_999, 40.0, True)])), False)],
        "sweep": [
            ("sweep_expiring",
             lambda r, now: r.sweep(now + 100.0, expire_after_s=50.0), True),
            ("sweep_decaying",
             lambda r, now: r.sweep(now + 1.0, decay_rate=0.5), True),
            ("sweep_clean", lambda r, now: r.sweep(now + 1.0), False)],
        "deregister": [
            ("deregister", lambda r, now: r.deregister(1), True),
            ("deregister_unknown", lambda r, now: r.deregister(9_999),
             False)],
        "register": [("register_new",
                      lambda r, now: r.register(500, 0, 3, now=now), True)],
        "heartbeat": [("heartbeat", lambda r, now: r.heartbeat(0, now + 0.1),
                       False)],
        "adopt_state": [("adopt_state_roundtrip",
                         lambda r, now: r.adopt_state(r.export_state()),
                         True)],
        "adopt_heartbeats": [("adopt_heartbeats", adopt_heartbeats, False)],
    }


def _port_scenarios():
    from repro_torch.core import types
    return _scenarios(types)


_CASES = [(m, sid, bumps) for m, sc in sorted(_port_scenarios().items())
          for sid, _, bumps in sc]


def test_scenarios_cover_every_derived_mutator():
    """The scenario table (the reference test's, ids and expectations
    included) covers exactly the port's derived mutators; heartbeat-only
    mutators never bump, every other one has a bumping scenario."""
    import test_sharded_registry as jt
    table = _port_scenarios()
    assert set(table) == set(port.registry_mutators())
    assert {m: [(s, b) for s, _, b in sc] for m, sc in table.items()} == \
        {m: [(s, b) for s, _, b in sc]
         for m, sc in jt.MUTATOR_SCENARIOS.items()}
    info = port.registry_mutator_info()
    for method, scenarios in table.items():
        bumps = [b for _, _, b in scenarios]
        assert any(bumps) != info[method].heartbeat_only, method


def _populate(reg, n=48, seed=1, now=0.0):
    rng = np.random.default_rng(seed)
    for pid in range(n):
        s = (pid % 4) * 3
        reg.register(pid, s, s + 3, now=now,
                     trust=float(rng.uniform(0.5, 1.0)),
                     latency_ms=float(rng.uniform(10, 300)))
        reg.heartbeat(pid, now)


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("method,name,bumps", _CASES,
                         ids=[c[1] for c in _CASES])
def test_port_mutators_bump_as_reference(shards, method, name, bumps):
    """Each scenario on the port's registry (``make_registry`` at 1 and 4
    shards) and on the reference's: the version vector moves exactly when
    the table says, on both, and the two vectors are equal before and
    after."""
    from repro.configs.base import GTRACConfig as JCfg
    from repro.core import types as jtypes
    from repro.core.sharding import make_registry as jmake
    from repro.sync.gossip import registry_version_vector as jvv
    from repro_torch.configs.base import GTRACConfig
    from repro_torch.core.sharding import make_registry
    from repro_torch.sync.gossip import registry_version_vector

    def run(make, cfg, vv, table):
        reg = make(cfg, shards=shards)
        _populate(reg)
        now = 5.0
        reg.heartbeat_all(range(48), now)
        before = vv(reg)
        call = next(c for sid, c, _ in table[method] if sid == name)
        call(reg, now)
        return before, vv(reg)

    got = run(make_registry, GTRACConfig(), registry_version_vector,
              _port_scenarios())
    want = run(jmake, JCfg(), jvv, _scenarios(jtypes))
    assert got == want
    assert (got[1] != got[0]) == bumps, (name, got)
