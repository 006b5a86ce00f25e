"""Analyzer-derived registry mutator set of the port's registry.

Port of ``repro.analysis.registry_contract`` over
``repro_torch.core.registry.AnchorRegistry``. A hand-kept list of
mutators lets a new registry mutator silently escape the version-bump
contract until someone remembers to enroll it. This module derives the
mutator set from the same AST classifier the ``version-bump`` lint rule
uses (:func:`repro_torch.analysis.rules.classify_registry_class`), so
the dynamic contract test and the static rule can never disagree about
what counts as a mutator, and new mutators are auto-enrolled: adding
one without a test scenario fails the contract test's completeness
assertion.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, FrozenSet, Optional

from repro_torch.analysis.rules import MethodInfo, classify_registry_class

_DEFAULT_CLASS = "AnchorRegistry"


def _registry_source() -> str:
    """The port's ``core/registry.py``, found beside this package (not
    imported: the linter needs only the standard library)."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "core", "registry.py")


def registry_mutator_info(
        src_path: Optional[str] = None,
        class_name: str = _DEFAULT_CLASS) -> Dict[str, MethodInfo]:
    """Classification of every method of the registry class, keyed by
    method name. Parses the source on disk — no instances involved."""
    path = src_path or _registry_source()
    with open(path, "r", encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            return classify_registry_class(node)
    raise LookupError(f"class {class_name} not found in {path}")


def registry_mutators(src_path: Optional[str] = None,
                      class_name: str = _DEFAULT_CLASS) -> FrozenSet[str]:
    """Public methods that mutate RegistryState (the set the version-bump
    contract test must cover). Heartbeat-only mutators are included —
    the contract test asserts they do NOT bump versions."""
    info = registry_mutator_info(src_path, class_name)
    return frozenset(name for name, mi in info.items()
                     if mi.mutates and not name.startswith("_"))
