"""shm-discipline — every shm segment carries the session prefix.

Port of ``ape_x_dqn_tpu/analysis/shm_discipline.py``.  The leak-guard
contract: all package-created ``/dev/shm`` segments are
named ``apx<APEX_SHM_SESSION>_*`` via ``shm_ring.session_shm_name`` /
``create_shared_memory``, so the test suite's leak guard can diff exactly
its own session's segments and concurrent runs never false-positive on
each other.  One raw ``SharedMemory(create=True)`` call site outside the
blessed module silently reintroduces anonymous segments that the guard
cannot attribute — this checker bans that statically.

Attaching (``SharedMemory(name=...)`` with no ``create=True``) is fine
anywhere: attach sites don't mint names.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ape_x_dqn_tpu_torch.analysis.core import SHM_BLESSED_PATH, Finding, Repo

CHECKER = "shm-discipline"


def _creates_segment(node: ast.Call) -> bool:
    for kw in node.keywords:
        if kw.arg == "create" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return True
    # SharedMemory(name, create, size): positional create.
    if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant) \
            and node.args[1].value is True:
        return True
    return False


def check(repo: Repo, blessed: Optional[str] = None) -> List[Finding]:
    blessed = blessed or SHM_BLESSED_PATH
    findings: List[Finding] = []
    for path in repo.files:
        if path == blessed:
            continue
        tree = repo.tree(path)
        if tree is None:
            continue
        func_stack: List[str] = []

        def visit(node, func_stack=func_stack, path=path):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func_stack.append(node.name)
                for child in ast.iter_child_nodes(node):
                    visit(child)
                func_stack.pop()
                return
            if isinstance(node, ast.Call):
                func = node.func
                callee = func.attr if isinstance(func, ast.Attribute) \
                    else (func.id if isinstance(func, ast.Name) else "")
                if callee == "SharedMemory" and _creates_segment(node):
                    where = func_stack[-1] if func_stack else "<module>"
                    findings.append(Finding(
                        checker=CHECKER, path=path, line=node.lineno,
                        key=f"raw-create:{path}:{where}",
                        message=(
                            "SharedMemory(create=True) outside "
                            f"{blessed} — segments must be minted via "
                            "session_shm_name/create_shared_memory so "
                            "the session leak guard can attribute them"),
                    ))
            for child in ast.iter_child_nodes(node):
                visit(child)

        visit(tree)
    return findings
