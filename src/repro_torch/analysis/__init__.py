"""repro_torch.analysis — the repo-specific AST invariant linter
("repolint") over the PyTorch port.

Port of ``repro.analysis``, stdlib only. Mechanizes the invariants the
reproduction established by hand: clock discipline, RNG discipline
(numpy, stdlib and torch's global generator), state-aliasing hygiene,
the registry version-bump contract, tracer hot-path guards, and
wire-safe RPC payloads. See ``python -m repro_torch.analysis
--list-rules``; the allow-list is ``repolint_torch.json`` at the repo
root.
"""
from repro_torch.analysis.core import (
    AllowEntry,
    Config,
    ConfigError,
    FileContext,
    Finding,
    Rule,
    RunReport,
    Walker,
    analyze_file,
    analyze_paths,
    find_config,
    load_config,
    scan_suppressions,
)
from repro_torch.analysis.registry_contract import (
    registry_mutator_info,
    registry_mutators,
)
from repro_torch.analysis.rules import ALL_RULES, build_rules

__all__ = [
    "ALL_RULES", "AllowEntry", "Config", "ConfigError", "FileContext",
    "Finding", "Rule", "RunReport", "Walker", "analyze_file",
    "analyze_paths", "build_rules", "find_config", "load_config",
    "registry_mutator_info", "registry_mutators", "scan_suppressions",
]
