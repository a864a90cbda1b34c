"""import-light — the torch-free-children contract, proven statically.

Port of ``ape_x_dqn_tpu/analysis/import_light.py``.  The port's child
processes live or die by spawn latency: replay shards respawn under
backoff mid-run, ``host_join`` attaches a whole remote host's workers,
and a spawned worker pays for every module its ring and codecs pull in.
All of them import a contracted set of modules — and none of those may
reach torch (or jax) through ANY transitive module-scope import, because
one heavy import turns a sub-second respawn into a multi-second stall
and, on a machine with a card, a CUDA context in a process that needs
none.

The proof is a static module-graph walk: module-scope imports only
(function-scope imports are lazy by construction — the package's blessed
escape hatch), with package ``__init__`` chains included, because
``import a.b.c`` executes ``a/__init__.py`` and ``a/b/__init__.py``
whether the importer wanted them or not.  The finding messages are the
JAX checker's word for word ("jax-free" there means free of every heavy
import), so both packages' reports on one tree compare equal.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ape_x_dqn_tpu_torch.analysis.core import (
    HEAVY_IMPORTS,
    IMPORT_LIGHT_CONTRACT,
    Finding,
    Repo,
    iter_module_scope,
)

CHECKER = "import-light"


def _module_scope_imports(tree: ast.AST, module: str, is_pkg: bool):
    """Yield (dotted_target, lineno, from_names) for every import that
    executes at module import time.  Relative imports resolve against
    ``module`` (whose package is itself when ``is_pkg``)."""
    pkg_parts = module.split(".") if is_pkg else module.split(".")[:-1]
    for node in iter_module_scope(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno, None
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                anchor = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                base = ".".join(anchor + ([node.module] if node.module
                                          else []))
            if base:
                yield base, node.lineno, [a.name for a in node.names]


def _edges_for(repo: Repo, path: str, modules: Dict[str, str],
               heavy: frozenset):
    """(internal_edges, heavy_edges) of one module: internal edges are
    (target_module, lineno); heavy edges are (heavy_root, lineno)."""
    tree = repo.tree(path)
    if tree is None:
        return [], []
    module = repo.module_name(path)
    is_pkg = path.endswith("__init__.py")
    internal: List[Tuple[str, int]] = []
    heavy_hits: List[Tuple[str, int]] = []
    for target, lineno, from_names in _module_scope_imports(
            tree, module, is_pkg):
        root = target.split(".")[0]
        if root in heavy:
            heavy_hits.append((root, lineno))
            continue
        candidates = []
        if target in modules or root in modules:
            # Importing a.b.c executes every ancestor package __init__.
            parts = target.split(".")
            for i in range(1, len(parts) + 1):
                prefix = ".".join(parts[:i])
                if prefix in modules:
                    candidates.append(prefix)
            if from_names:
                for name in from_names:
                    sub = f"{target}.{name}"
                    if sub in modules:
                        candidates.append(sub)
        for cand in candidates:
            internal.append((cand, lineno))
    return internal, heavy_hits


def check(repo: Repo, roots: Optional[Sequence[str]] = None,
          heavy: Optional[frozenset] = None) -> List[Finding]:
    roots = tuple(roots if roots is not None else IMPORT_LIGHT_CONTRACT)
    heavy = frozenset(heavy if heavy is not None else HEAVY_IMPORTS)
    modules = repo.module_paths()

    # Edge cache: module -> (internal edges, heavy edges).
    cache: Dict[str, Tuple[list, list]] = {}

    def edges(mod: str):
        if mod not in cache:
            cache[mod] = _edges_for(repo, modules[mod], modules, heavy)
        return cache[mod]

    findings: List[Finding] = []
    for root in roots:
        if root not in modules:
            findings.append(Finding(
                checker=CHECKER, path="<contract>", line=0,
                key=f"missing-root:{root}",
                message=(f"import-light contract names {root} but no such "
                         "module exists in the repo — update the contract"),
            ))
            continue
        # BFS with parent pointers for chain reconstruction; ancestor
        # packages of the root itself execute first, so seed them too.
        parent: Dict[str, Optional[str]] = {}
        queue: List[str] = []
        parts = root.split(".")
        for i in range(1, len(parts) + 1):
            prefix = ".".join(parts[:i])
            if prefix in modules and prefix not in parent:
                parent[prefix] = None if prefix == root else root
                queue.append(prefix)
        if root not in parent:
            parent[root] = None
            queue.append(root)
        reported: Set[str] = set()
        while queue:
            mod = queue.pop(0)
            internal, heavy_hits = edges(mod)
            for heavy_root, lineno in heavy_hits:
                if heavy_root in reported:
                    continue
                reported.add(heavy_root)
                chain: List[str] = [mod]
                cur = parent[mod]
                while cur is not None:
                    chain.append(cur)
                    cur = parent[cur]
                chain.reverse()
                findings.append(Finding(
                    checker=CHECKER, path=modules[mod], line=lineno,
                    key=f"{root}->{heavy_root}",
                    message=(
                        f"{root} is contracted jax-free but reaches "
                        f"{heavy_root} at module scope via "
                        f"{' -> '.join(chain)} "
                        f"({modules[mod]}:{lineno}); move the import into "
                        "the function that needs it, or break the chain"
                    ),
                ))
            for target, _lineno in internal:
                if target not in parent:
                    parent[target] = mod
                    queue.append(target)
    return findings
