"""config-coverage — no ghost knobs, no undocumented knobs.

Port of ``ape_x_dqn_tpu/analysis/config_coverage.py``.  String-keyed
JSON fetched with no schema reads a typo'd key as its default, silently.
``config.py``'s typed dataclasses kill that at load time — but an ATTRIBUTE READ of a field
that was later renamed/removed still only fails when that code path
runs, which for chaos/fallback paths can be never-in-CI.  This checker
closes the loop statically, both directions:

  * **ghost knobs**: every ``cfg.<section>.<field>`` attribute read (and
    ``getattr(cfg.<section>, "field", ...)``) in the package must name a
    field declared on that section's dataclass;
  * **undocumented knobs**: every declared field must be mentioned in
    dotted ``section.field`` form in README.md or docs/METRICS.md — a
    knob an operator cannot discover is a knob that gets re-invented.

The read-side heuristic keys on the receiver being named like a config
(``cfg``/``config``/``*_cfg`` …, incl. ``self.cfg``); a section object
held in a differently-named local is invisible to it (documented
limitation — the declaration side and the validate() sweep still cover
those fields).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Tuple

from ape_x_dqn_tpu_torch.analysis.core import (
    CONFIG_DOC_PATHS,
    CONFIG_PATH,
    CONFIG_ROOT_CLASS as ROOT_CLASS,
    Finding,
    Repo,
)

CHECKER = "config-coverage"

_CFGISH = re.compile(r"(^|_)(cfg|config|conf)$")


def _declared_sections(repo: Repo, config_path: str, root_class: str):
    """({section: {field: lineno}}, {section: class_name}) parsed from the
    config module: the root dataclass's annotated fields whose annotation
    names another class in the same file are sections; that class's
    annotated fields are the knobs."""
    tree = repo.tree(config_path)
    classes: Dict[str, ast.ClassDef] = {}
    if tree is None:
        return {}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            classes[node.name] = node
    root = classes.get(root_class)
    sections: Dict[str, Dict[str, int]] = {}
    if root is None:
        return sections, {}
    names: Dict[str, str] = {}
    for stmt in root.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                          ast.Name):
            ann = stmt.annotation
            if isinstance(ann, ast.Name) and ann.id in classes:
                names[stmt.target.id] = ann.id
    for section, cls_name in names.items():
        fields: Dict[str, int] = {}
        for stmt in classes[cls_name].body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name):
                fields[stmt.target.id] = stmt.lineno
        sections[section] = fields
    return sections, names


def _attr_chain(node: ast.Attribute) -> Optional[List[str]]:
    """['root', 'a', 'b'] for root.a.b, None for non-name roots."""
    parts: List[str] = []
    cur: ast.AST = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        parts.reverse()
        return parts
    return None


def _reads(tree: ast.AST, sections: Dict[str, Dict[str, int]]):
    """Yield (section, field, lineno) for cfg-ish section.field reads,
    including getattr(cfg.section, "field"[, default])."""
    handled_attrs = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "getattr" and len(node.args) >= 2 \
                and isinstance(node.args[0], ast.Attribute) \
                and isinstance(node.args[1], ast.Constant) \
                and isinstance(node.args[1].value, str):
            chain = _attr_chain(node.args[0])
            if chain and len(chain) >= 2 and chain[-1] in sections \
                    and _CFGISH.search(chain[-2].lower()):
                yield chain[-1], node.args[1].value, node.lineno
                handled_attrs.add(id(node.args[0]))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and id(node) not in handled_attrs:
            chain = _attr_chain(node)
            if not chain or len(chain) < 3:
                continue
            # Longest chains only: walking yields sub-attributes too, so
            # key on the section appearing right after a cfg-ish name and
            # exactly one field behind it.
            for i in range(1, len(chain) - 1):
                if chain[i] in sections and _CFGISH.search(
                        chain[i - 1].lower()):
                    yield chain[i], chain[i + 1], node.lineno
                    break


def check(repo: Repo, config_path: Optional[str] = None,
          root_class: str = ROOT_CLASS,
          doc_paths: Optional[Sequence[str]] = None,
          doc_text: Optional[str] = None) -> List[Finding]:
    config_path = config_path or CONFIG_PATH
    doc_paths = tuple(doc_paths if doc_paths is not None
                      else CONFIG_DOC_PATHS)
    findings: List[Finding] = []
    sections, _names = _declared_sections(repo, config_path, root_class)
    if not sections:
        return [Finding(
            checker=CHECKER, path=config_path, line=0,
            key="no-config",
            message=(f"could not parse {root_class} sections out of "
                     f"{config_path} — the checker's model of the config "
                     "module is broken"),
        )]

    # Ghost knobs: reads naming undeclared fields.
    seen_ghosts = set()
    for path in repo.files:
        if path == config_path:
            continue            # declaration + validate() self-reads
        tree = repo.tree(path)
        if tree is None:
            continue
        for section, field, lineno in _reads(tree, sections):
            if field.startswith("__"):
                continue
            if field not in sections[section]:
                key = f"ghost:{section}.{field}"
                if (key, path) in seen_ghosts:
                    continue
                seen_ghosts.add((key, path))
                findings.append(Finding(
                    checker=CHECKER, path=path, line=lineno,
                    key=key,
                    message=(f"reads cfg.{section}.{field} but "
                             f"{section} declares no such field in "
                             f"{config_path} — a ghost knob reads as "
                             "AttributeError only on the path that runs "
                             "it"),
                ))

    # Undocumented knobs: declared fields without a dotted doc mention.
    if doc_text is None:
        doc_text = "\n".join(repo.read_doc(p) for p in doc_paths)
    for section in sorted(sections):
        for field, lineno in sorted(sections[section].items()):
            dotted = f"{section}.{field}"
            if dotted not in doc_text:
                findings.append(Finding(
                    checker=CHECKER, path=config_path, line=lineno,
                    key=f"undocumented:{dotted}",
                    message=(f"config knob {dotted} is declared but "
                             f"mentioned in none of {', '.join(doc_paths)}"
                             " — an operator cannot discover it"),
                ))
    return findings
