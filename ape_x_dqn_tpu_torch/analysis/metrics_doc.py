"""metrics-doc — every observable name is documented, statically.

Port of ``ape_x_dqn_tpu/analysis/metrics_doc.py``; the port registers the
JAX package's names, so both are held to the one docs/METRICS.md.
docs/METRICS.md is a contract, not prose: obs tooling (obs_top,
downstream scrapers) parses the JSONL stream and /varz by the names
documented there.  The runtime schema pins prove section KEY LISTS
against live dicts one schema at a time; this checker generalizes the
other half mechanically: every registry
instrument name (``registry.counter/gauge/histogram("...")``), every
``register_provider("...")`` /varz section, and every
``register_jsonl_section("...")`` emit key declared ANYWHERE in the
package must appear (in backticks) in docs/METRICS.md — or, for a name
only the port has, in the README's port section (``METRICS_DOC_PATHS``).

Only string-literal names are checkable statically; a dynamically
formatted name (the chaos monkey's per-kind counters) is skipped — the
runtime pins still cover those surfaces.

The module also owns the doc parser the runtime pins share
(:func:`doc_section_keys`).
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence, Tuple

from ape_x_dqn_tpu_torch.analysis.core import (
    METRICS_DOC_PATH,
    METRICS_DOC_PATHS,
    METRICS_EXCLUDED_PATHS,
    Finding,
    Repo,
)

CHECKER = "metrics-doc"

_INSTRUMENT_ATTRS = ("counter", "gauge", "histogram")
_REGISTRAR_NAMES = ("register_provider", "register_jsonl_section")


def doc_section_keys(section_header: str,
                     doc_path: Optional[str] = None) -> List[str]:
    """The ``- `key` — …`` names under one ``## …`` header of
    docs/METRICS.md — the parser the runtime schema pins share."""
    if doc_path is None:
        doc_path = os.path.join(
            os.path.dirname(__file__), "..", "..", METRICS_DOC_PATH)
    with open(doc_path, encoding="utf-8") as f:
        text = f.read()
    if section_header not in text:
        return []
    section = text.split(section_header, 1)[1]
    keys: List[str] = []
    for line in section.splitlines():
        line = line.strip()
        if line.startswith("- `"):
            keys.append(line.split("`")[1])
        elif line.startswith("## "):
            break
    return keys


def _declared_names(repo: Repo, excluded: Sequence[str]):
    """(kind, name, path, lineno) for every literal-named instrument or
    section registration in the scanned tree."""
    for path in repo.files:
        if path in excluded:
            continue
        tree = repo.tree(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                continue
            func = node.func
            if isinstance(func, ast.Attribute):
                name = func.attr
            elif isinstance(func, ast.Name):
                name = func.id
            else:
                continue
            if name in _INSTRUMENT_ATTRS:
                # Guard against stdlib lookalikes: instrument names are
                # slash-or-word metrics paths, never spaces.
                if " " in first.value:
                    continue
                yield "instrument", first.value, path, node.lineno
            elif name in _REGISTRAR_NAMES:
                yield "section", first.value, path, node.lineno


def check(repo: Repo, doc_text: Optional[str] = None,
          doc_path: Optional[str] = None,
          excluded: Optional[Sequence[str]] = None) -> List[Finding]:
    if doc_text is None:
        doc_text = "\n".join(repo.read_doc(p) for p in (
            (doc_path,) if doc_path else METRICS_DOC_PATHS))
    excluded = tuple(excluded if excluded is not None
                     else METRICS_EXCLUDED_PATHS)
    findings: List[Finding] = []
    seen = set()
    for kind, name, path, lineno in _declared_names(repo, excluded):
        key = f"{kind}:{name}"
        if key in seen:
            continue
        seen.add(key)
        if f"`{name}`" not in doc_text:
            what = ("registry instrument" if kind == "instrument"
                    else "JSONL/varz section")
            findings.append(Finding(
                checker=CHECKER, path=path, line=lineno,
                key=key,
                message=(f"{what} `{name}` is registered here but not "
                         f"documented in {METRICS_DOC_PATH} — the schema "
                         "doc is the contract obs tooling parses"),
            ))
    return findings
