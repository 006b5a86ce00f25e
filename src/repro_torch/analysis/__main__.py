"""CLI: ``python -m repro_torch.analysis [paths]`` (default
``src/repro_torch``), under ``repolint_torch.json``.

Exit codes: 0 clean, 1 findings (including unused suppressions /
allow-list entries), 2 usage or config error.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis.core import (Config, ConfigError, analyze_paths,
                                 find_config, load_config)
from repro_torch.analysis.rules import ALL_RULES, build_rules


def _list_rules() -> str:
    lines = []
    for cls in ALL_RULES:
        lines.append(f"{cls.rule_id:16s} {cls.doc}")
        lines.append(f"{'':16s}   motivation: {cls.motivation}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-specific AST invariant linter (repolint)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files/directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--config", default=None,
                    help="allow-list config (default: nearest "
                         "repolint_torch.json upward from cwd)")
    ap.add_argument("--no-config", action="store_true",
                    help="ignore any repolint_torch.json (bare rule run)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable JSON report on stdout")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule set and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0

    try:
        if args.no_config:
            config = Config()
        else:
            cfg_path = args.config or find_config()
            known = [c.rule_id for c in ALL_RULES]
            config = load_config(cfg_path, known) if cfg_path else Config()
        rules = build_rules(config.options)
        run = analyze_paths(args.paths or ["src/repro_torch"], rules,
                            config)
    except ConfigError as e:
        print(f"repolint: error: {e}", file=sys.stderr)
        return 2

    if args.as_json:
        print(json.dumps(run.to_json(), indent=2, sort_keys=True))
        return 1 if run.findings else 0

    findings: List = sorted(run.findings,
                            key=lambda f: (f.path, f.line, f.rule))
    allowed = sorted(run.allowed, key=lambda a: (a[0].path, a[0].line))
    for f, why in allowed:
        print(f"allowed: {f.render()}")
        print(f"         why: {why}")
    for f in findings:
        print(f.render())
    n, a = len(findings), len(allowed)
    print(f"repolint: {run.files} files, {n} finding(s), {a} allowed")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
