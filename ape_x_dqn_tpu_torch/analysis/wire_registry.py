"""wire-registry — one registry for frame kinds and protocol magics.

Port of ``ape_x_dqn_tpu/analysis/wire_registry.py``.  Three protocols
(experience, serving, replay RPC) ride one frame discipline, so
``runtime/net.py`` is the single registry of ``F_*`` frame kinds and
wire magics.  Kind values share one namespace (one
parser verifies them all); a duplicated value or a re-declared constant
in ``serving/`` or ``replay/service.py`` is exactly the drift that
turns "torn frame, retired connection" into "silently decoded as the
wrong protocol".

Rules:
  * every ``F_*`` kind is declared exactly once, in net.py, with a
    unique value;
  * no module outside net.py declares an ``F_*`` constant;
  * no comparison tests a kind variable against a raw int literal that
    collides with a registered kind value — always the named constant;
  * a 4-byte ``*MAGIC*`` constant's value is declared by at most one
    module, unless an ``ALLOWED_MAGIC_DUPES`` entry lists the exact
    file set (and then EVERY listed file must declare the identical
    bytes — the allowance is a drift guard, not a hole);
  * wire-plane modules (``WIRE_PLANE_PATHS``: serving/,
    replay/service.py) must not declare their own magics at all —
    theirs live in the net.py registry (which is itself not in that
    list: it is where the magics are declared);
  * every registered kind is referenced somewhere (no dead registry
    rows);
  * a function that dispatches on frame kinds must show evidence of an
    explicit rejection path (a torn/reject/bad/close/error identifier)
    — the heuristic teeth behind "handled or explicitly rejected".
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Tuple

from ape_x_dqn_tpu_torch.analysis.core import (
    ALLOWED_MAGIC_DUPES,
    NET_REGISTRY_PATH,
    WIRE_PLANE_PATHS,
    Finding,
    Repo,
    iter_module_scope,
)

CHECKER = "wire-registry"

_KIND_NAME = re.compile(r"^F_[A-Z0-9_]+$")
_REJECT_VOCAB = re.compile(
    r"torn|reject|unknown|unexpected|bad|err|close|retire|drop|refuse",
    re.IGNORECASE,
)


def _module_scope_assigns(tree: ast.AST):
    for node in iter_module_scope(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            yield node.targets[0].id, node.value, node.lineno


def _kind_decls(repo: Repo, net_path: str) -> Dict[str, Tuple[int, int]]:
    """F_* name -> (value, lineno) in the registry module."""
    tree = repo.tree(net_path)
    out: Dict[str, Tuple[int, int]] = {}
    if tree is None:
        return out
    for name, value, lineno in _module_scope_assigns(tree):
        if _KIND_NAME.match(name) and isinstance(value, ast.Constant) \
                and isinstance(value.value, int):
            out[name] = (value.value, lineno)
    return out


def _magic_decls(repo: Repo):
    """(path, name, bytes value, lineno) for every module-scope 4-byte
    *MAGIC* constant in the scanned tree."""
    for path in repo.files:
        tree = repo.tree(path)
        if tree is None:
            continue
        for name, value, lineno in _module_scope_assigns(tree):
            if "MAGIC" in name and isinstance(value, ast.Constant) \
                    and isinstance(value.value, bytes) \
                    and len(value.value) == 4:
                yield path, name, value.value, lineno


def _is_kindish(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return "kind" in node.id.lower()
    if isinstance(node, ast.Attribute):
        return "kind" in node.attr.lower()
    return False


def check(repo: Repo, net_path: Optional[str] = None,
          allowed_dupes: Optional[dict] = None,
          wire_plane: Optional[Sequence[str]] = None) -> List[Finding]:
    net_path = net_path or NET_REGISTRY_PATH
    allowed = ALLOWED_MAGIC_DUPES if allowed_dupes is None else allowed_dupes
    wire_plane = tuple(wire_plane if wire_plane is not None
                       else WIRE_PLANE_PATHS)
    findings: List[Finding] = []

    kinds = _kind_decls(repo, net_path)
    kind_values: Dict[int, List[str]] = {}
    for name, (value, lineno) in kinds.items():
        kind_values.setdefault(value, []).append(name)
    for value, names in sorted(kind_values.items()):
        if len(names) > 1:
            first = sorted(names)[0]
            for name in sorted(names)[1:]:
                findings.append(Finding(
                    checker=CHECKER, path=net_path, line=kinds[name][1],
                    key=f"dup-kind-value:{name}",
                    message=(f"frame kind {name} = {value} collides with "
                             f"{first} — kind values share one namespace "
                             "(one parser verifies all three protocols)"),
                ))
    kind_value_set = {value for value, _lineno in kinds.values()}

    # Magic registry: group declarations by value.
    by_value: Dict[bytes, List[Tuple[str, str, int]]] = {}
    for path, name, value, lineno in _magic_decls(repo):
        by_value.setdefault(value, []).append((path, name, lineno))
        if any(path.startswith(p) if p.endswith("/") else path == p
               for p in wire_plane):
            findings.append(Finding(
                checker=CHECKER, path=path, line=lineno,
                key=f"wire-plane-magic:{path}:{name}",
                message=(f"{name} declares a protocol magic inside the "
                         f"wire plane — magics live once in {net_path} "
                         "(import the name instead)"),
            ))
    for value, decls in sorted(by_value.items()):
        allow = allowed.get(value)
        if len(decls) > 1:
            files = {p for p, _, _ in decls}
            if allow is None or files - set(allow["files"]):
                # The registry module wins the "canonical owner" slot;
                # the finding lands on the other declaration sites.
                decls_sorted = sorted(
                    decls, key=lambda d: (d[0] != net_path, d))
                keep = decls_sorted[0]
                for path, name, lineno in decls_sorted[1:]:
                    findings.append(Finding(
                        checker=CHECKER, path=path, line=lineno,
                        key=f"dup-magic:{path}:{name}",
                        message=(f"magic {value!r} ({name}) is also "
                                 f"declared as {keep[1]} in {keep[0]} — "
                                 "two protocols sharing a magic can be "
                                 "confused at a handshake; register one "
                                 "owner (or an ALLOWED_MAGIC_DUPES entry "
                                 "with a reason)"),
                    ))
    # Verify allowed-dupe entries are intact: every listed file declares
    # exactly that value (drift in any member = finding).
    for value, allow in sorted(allowed.items()):
        declaring = {p for p, _, _ in by_value.get(value, [])}
        for missing in sorted(set(allow["files"]) - declaring):
            if missing in repo.files:
                findings.append(Finding(
                    checker=CHECKER, path=missing, line=0,
                    key=f"dupe-drift:{missing}:{value!r}",
                    message=(f"{missing} is pinned by ALLOWED_MAGIC_DUPES "
                             f"to declare {value!r} but no longer does — "
                             "the blessed duplicate has drifted"),
                ))

    # Package-wide: F_* re-declarations, int-literal kind compares, and
    # decode-dispatch rejection evidence.
    referenced_kinds: set = set()
    for path in repo.files:
        tree = repo.tree(path)
        if tree is None:
            continue
        if path != net_path:
            for name, _value, lineno in _module_scope_assigns(tree):
                if _KIND_NAME.match(name):
                    findings.append(Finding(
                        checker=CHECKER, path=path, line=lineno,
                        key=f"redeclared-kind:{path}:{name}",
                        message=(f"{name} declared outside the registry — "
                                 f"frame kinds live once in {net_path}"),
                    ))
        for node in ast.walk(tree):
            if isinstance(node, ast.Name) and node.id in kinds \
                    and isinstance(node.ctx, ast.Load):
                referenced_kinds.add(node.id)
            if isinstance(node, ast.Compare):
                operands = [node.left] + list(node.comparators)
                if any(_is_kindish(op) for op in operands):
                    for op in operands:
                        if isinstance(op, ast.Constant) \
                                and isinstance(op.value, int) \
                                and not isinstance(op.value, bool) \
                                and op.value in kind_value_set:
                            findings.append(Finding(
                                checker=CHECKER, path=path,
                                line=node.lineno,
                                key=(f"kind-literal:{path}:"
                                     f"{op.value}"),
                                message=(
                                    f"kind compared against raw literal "
                                    f"{op.value} — use the registered "
                                    f"F_* name from {net_path} (a "
                                    "renumbered registry would silently "
                                    "diverge from this site)"),
                            ))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                dispatches = False
                vocab_hit = False
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Compare):
                        ops = [sub.left] + list(sub.comparators)
                        if any(isinstance(o, ast.Name) and o.id in kinds
                               for o in ops):
                            dispatches = True
                    if isinstance(sub, ast.Name) \
                            and _REJECT_VOCAB.search(sub.id):
                        vocab_hit = True
                    elif isinstance(sub, ast.Attribute) \
                            and _REJECT_VOCAB.search(sub.attr):
                        vocab_hit = True
                    elif isinstance(sub, ast.Constant) \
                            and isinstance(sub.value, str) \
                            and _REJECT_VOCAB.search(sub.value):
                        vocab_hit = True
                if dispatches and not vocab_hit:
                    findings.append(Finding(
                        checker=CHECKER, path=path, line=node.lineno,
                        key=f"no-reject-path:{path}:{node.name}",
                        message=(
                            f"{node.name}() dispatches on frame kinds but "
                            "shows no explicit rejection path (no torn/"
                            "reject/bad/close/error identifier) — unknown "
                            "kinds must be counted and refused, never "
                            "silently ignored"),
                    ))

    # Dead registry rows: a kind nobody references outside its own
    # declaration line.
    for name, (value, lineno) in sorted(kinds.items()):
        if name not in referenced_kinds:
            findings.append(Finding(
                checker=CHECKER, path=net_path, line=lineno,
                key=f"dead-kind:{name}",
                message=(f"frame kind {name} = {value} is registered but "
                         "never referenced — dead registry rows hide real "
                         "coverage gaps"),
            ))
    return findings
