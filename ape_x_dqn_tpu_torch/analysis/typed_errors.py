"""typed-errors — decode and supervision paths fail typed, never silent.

Port of ``ape_x_dqn_tpu/analysis/typed_errors.py``.  The port's whole
fault story is typed degradation: torn frames counted
and refused, shard outages surfacing as ``ReplayShardUnavailable``,
restores walking a corrupt chain back LOUDLY.  A bare ``except:`` or a
silent ``except Exception: pass`` in ``runtime/``, ``serving/`` or
``replay/`` is the one construct that can void all of it — a decode
fault swallowed there never becomes a counter, a health transition or a
typed refusal.

Rules:
  * bare ``except:`` — always a finding (it also eats KeyboardInterrupt
    and SystemExit, wedging shutdown);
  * a BROAD handler (``Exception``/``BaseException``) whose body is
    only ``pass``/``continue`` must justify itself IN PLACE with the
    package's existing convention: a trailing ``# noqa: BLE001 — <reason>``
    comment on the ``except`` line, reason nonempty.  Best-effort
    teardown is legitimate; *unexplained* best-effort is how decode
    bugs hide.

Narrow typed handlers (``except OSError: pass``) are exempt: naming the
exception type IS the justification.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Sequence

from ape_x_dqn_tpu_torch.analysis.core import TYPED_ERROR_DIRS, Finding, Repo

CHECKER = "typed-errors"

_BROAD = {"Exception", "BaseException"}
_JUSTIFIED = re.compile(r"#\s*noqa:\s*BLE001\b(?P<reason>.*)$")


def _is_broad(type_node: Optional[ast.AST]) -> bool:
    if type_node is None:
        return True
    if isinstance(type_node, ast.Name):
        return type_node.id in _BROAD
    if isinstance(type_node, ast.Attribute):
        return type_node.attr in _BROAD
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad(el) for el in type_node.elts)
    return False


def _is_silent(body: Sequence[ast.stmt]) -> bool:
    return all(isinstance(stmt, (ast.Pass, ast.Continue)) for stmt in body)


def _has_reason(line: str) -> bool:
    m = _JUSTIFIED.search(line)
    if not m:
        return False
    reason = m.group("reason").strip(" -—–:")
    return sum(c.isalpha() for c in reason) >= 3


def check(repo: Repo, dirs: Optional[Sequence[str]] = None) -> List[Finding]:
    dirs = tuple(dirs if dirs is not None else TYPED_ERROR_DIRS)
    findings: List[Finding] = []
    for path in repo.files:
        if not any(path.startswith(d.rstrip("/") + "/") or path == d
                   for d in dirs):
            continue
        tree = repo.tree(path)
        if tree is None:
            continue
        lines = repo.text(path).splitlines()

        def walk(node, func="<module>", ordinals=None, path=path,
                 lines=lines):
            if ordinals is None:
                ordinals = {}
            for child in ast.iter_child_nodes(node):
                child_func = func
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    child_func = child.name
                    walk(child, child_func, {}, path, lines)
                    continue
                if isinstance(child, ast.ExceptHandler):
                    if child.type is None:
                        n = ordinals.setdefault(("bare", func), 0)
                        ordinals[("bare", func)] = n + 1
                        findings.append(Finding(
                            checker=CHECKER, path=path, line=child.lineno,
                            key=f"bare-except:{path}:{func}:{n}",
                            message=(
                                f"bare `except:` in {func}() — it also "
                                "swallows KeyboardInterrupt/SystemExit; "
                                "name the exception type"),
                        ))
                    elif _is_broad(child.type) and _is_silent(child.body):
                        src = lines[child.lineno - 1] \
                            if child.lineno - 1 < len(lines) else ""
                        if not _has_reason(src):
                            n = ordinals.setdefault(("silent", func), 0)
                            ordinals[("silent", func)] = n + 1
                            findings.append(Finding(
                                checker=CHECKER, path=path,
                                line=child.lineno,
                                key=f"silent-swallow:{path}:{func}:{n}",
                                message=(
                                    f"silent broad swallow in {func}() "
                                    "without justification — narrow the "
                                    "type, surface the failure, or "
                                    "annotate `# noqa: BLE001 — <why "
                                    "best-effort is correct here>`"),
                            ))
                walk(child, child_func, ordinals, path, lines)

        walk(tree)
    return findings
