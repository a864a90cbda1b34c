"""apexlint core — findings, the repo scanner, and the baseline protocol.

Port of ``ape_x_dqn_tpu/analysis/core.py``, aimed at this package.  The
port rests on invariants that its modules state in prose and its tests
pin one at a time: writer-side and child-process modules stay torch-free
for a fast spawn, every wire kind and magic is registered once, every
config knob is declared and documented, metric names match
docs/METRICS.md, shm segments carry the session prefix, and failures stay
typed.  ``ape_x_dqn_tpu_torch/analysis`` turns each of those contracts
into a static AST/import-graph checker; this module is the shared
plumbing, and holds every piece of contract data the checkers read.

Deliberately import-light (stdlib only): the lint gate's budget is
seconds, and the analysis package itself is part of the import-lightness
contract it enforces.

The suppression protocol: findings carry a STABLE key (no line numbers —
lines drift under unrelated edits), and ``baseline.json`` next to this
module may grandfather a (checker, key) pair *with a one-line reason*.
A baseline entry without a reason is itself an error; a finding not in
the baseline is NEW and fails the CLI.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# The port's contracts, in one place.  Checkers read these as defaults;
# tests point the same checkers at fixture trees with other values.
# ---------------------------------------------------------------------------

#: The package the contracts below describe, and the default scan root.
PACKAGE = "ape_x_dqn_tpu_torch"

#: Importing any of these at module scope makes a process "heavy": multi-
#: second spawn, a device runtime, GiBs of RSS.  The import-light contract
#: is that the modules below never reach one of these transitively.  For
#: the port ``torch`` is the one that matters: writer-side modules load no
#: torch.
HEAVY_IMPORTS = frozenset(
    {"jax", "jaxlib", "flax", "optax", "chex", "orbax", "tensorflow",
     "torch"}
)

#: Modules contracted to run in torch-free child processes (fast spawn):
#: the replay shard server path, the wire codecs, the worker-side shm
#: stats block, the fleet aggregator and membership registry, the remote-
#: host launcher — and this analysis package and its CLI (the lint gate's
#: time budget).  JAX's contract also names ``tools.xp_transport``, the
#: by-path loader of the experience codecs; it has no counterpart in the
#: port, so it has no entry here.
IMPORT_LIGHT_CONTRACT: Tuple[str, ...] = (
    "ape_x_dqn_tpu_torch.replay.service",
    "ape_x_dqn_tpu_torch.runtime.net",
    "ape_x_dqn_tpu_torch.runtime.shm_ring",
    "ape_x_dqn_tpu_torch.obs.shm_stats",
    "ape_x_dqn_tpu_torch.obs.fleet",
    "ape_x_dqn_tpu_torch.fleet",
    "ape_x_dqn_tpu_torch.analysis",
    "ape_x_dqn_tpu_torch.host_join",
    "ape_x_dqn_tpu_torch.lint",
)

#: Magics that MAY be declared in more than one module, each entry the
#: exact file set allowed to declare that value plus the reason.  The
#: checker verifies the duplication is intact (every listed file declares
#: the identical bytes) — the allowance is a drift GUARD, not a hole.
ALLOWED_MAGIC_DUPES: Dict[bytes, Dict[str, object]] = {
    b"APXT": {
        "files": frozenset({
            "ape_x_dqn_tpu_torch/utils/serialization.py",
            "ape_x_dqn_tpu_torch/runtime/net.py",
            "ape_x_dqn_tpu_torch/runtime/shm_ring.py",
        }),
        "reason": (
            "net.py and shm_ring.py stay loadable without the package "
            "import (net.py's dedup encoder walks a record without "
            "importing shm_ring), so they re-declare serialization.py's "
            "APXT record magic; this entry pins all three to the "
            "identical value"
        ),
    },
}

#: Where the wire-kind/magic registry lives (checker: wire-registry).
NET_REGISTRY_PATH = "ape_x_dqn_tpu_torch/runtime/net.py"

#: Wire-plane modules that must not declare a protocol magic of their own
#: (checker: wire-registry): a trailing ``/`` names a directory.  The
#: registry module is deliberately NOT listed: it is where the magics are
#: declared, and listing it would flag every one of them.
WIRE_PLANE_PATHS: Tuple[str, ...] = (
    "ape_x_dqn_tpu_torch/serving/",
    "ape_x_dqn_tpu_torch/replay/service.py",
)

#: Dirs whose decode and supervision paths must fail typed (checker:
#: typed-errors): no bare ``except:``, and a silent broad swallow must
#: carry an in-place ``# noqa: BLE001 — <reason>`` justification.
TYPED_ERROR_DIRS: Tuple[str, ...] = (
    "ape_x_dqn_tpu_torch/runtime",
    "ape_x_dqn_tpu_torch/serving",
    "ape_x_dqn_tpu_torch/replay",
)

#: The one module allowed to call SharedMemory(create=True) directly —
#: everything else must flow through its session-prefixed helpers
#: (checker: shm-discipline).
SHM_BLESSED_PATH = "ape_x_dqn_tpu_torch/runtime/shm_ring.py"

#: The config module and its root dataclass (checker: config-coverage).
CONFIG_PATH = "ape_x_dqn_tpu_torch/config.py"
CONFIG_ROOT_CLASS = "ApexConfig"

#: Docs a config knob may be documented in (checker: config-coverage).
#: The port's knobs are the JAX package's; a knob only the port has is
#: documented in the README's port section.
CONFIG_DOC_PATHS: Tuple[str, ...] = ("README.md", "docs/METRICS.md")

#: The metrics schema contract doc (checker: metrics-doc), shared with the
#: JAX package: the port declares the same names.  A name only the port
#: has is documented in the README's port section, so the checker reads
#: both by default.
METRICS_DOC_PATH = "docs/METRICS.md"
METRICS_DOC_PATHS: Tuple[str, ...] = (METRICS_DOC_PATH, "README.md")

#: Modules that define the instrument primitives: their own
#: ``counter(...)``/``gauge(...)`` calls are not usages (checker:
#: metrics-doc).
METRICS_EXCLUDED_PATHS: Tuple[str, ...] = (
    "ape_x_dqn_tpu_torch/obs/registry.py",
    "ape_x_dqn_tpu_torch/utils/metrics.py",
)


# ---------------------------------------------------------------------------
# Findings.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation.

    ``key`` is the suppression identity: stable under unrelated edits
    (never a line number), unique enough to pin one violation.  ``path``
    and ``line`` are for the human reading the report.
    """

    checker: str
    path: str
    line: int
    key: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# The repo scanner: one parse per file, shared by every checker.
# ---------------------------------------------------------------------------

class Repo:
    """Lazy-parsing view of the python files under the scanned roots.

    Paths are repo-relative with ``/`` separators; ``tree``/``text`` are
    cached so six checkers cost one parse per file.  A file that fails
    to parse yields a ``parse-error`` finding instead of an exception —
    the linter must report on a broken tree, not crash with it.
    """

    def __init__(self, root: str, rel_dirs: Sequence[str] = (PACKAGE,)):
        self.root = os.path.abspath(root)
        self.rel_dirs = tuple(rel_dirs)
        self._texts: Dict[str, str] = {}
        self._trees: Dict[str, Optional[ast.AST]] = {}
        self.parse_failures: List[Finding] = []
        self.files: List[str] = []
        for rel in self.rel_dirs:
            base = os.path.join(self.root, rel)
            if os.path.isfile(base) and base.endswith(".py"):
                self.files.append(rel.replace(os.sep, "/"))
                continue
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d != "__pycache__" and not d.startswith(".")
                )
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        full = os.path.join(dirpath, fn)
                        self.files.append(
                            os.path.relpath(full, self.root).replace(
                                os.sep, "/")
                        )
        self.files.sort()

    def text(self, path: str) -> str:
        if path not in self._texts:
            with open(os.path.join(self.root, path), encoding="utf-8") as f:
                self._texts[path] = f.read()
        return self._texts[path]

    def tree(self, path: str) -> Optional[ast.AST]:
        if path not in self._trees:
            try:
                self._trees[path] = ast.parse(self.text(path), filename=path)
            except SyntaxError as e:
                self._trees[path] = None
                self.parse_failures.append(Finding(
                    checker="parse-error", path=path,
                    line=int(e.lineno or 0), key=f"parse:{path}",
                    message=f"file does not parse: {e.msg}",
                ))
        return self._trees[path]

    def module_name(self, path: str) -> str:
        """Dotted module name of a repo-relative path (packages by
        directory; ``pkg/__init__.py`` → ``pkg``)."""
        parts = path[:-3].split("/")          # strip .py
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    def module_paths(self) -> Dict[str, str]:
        return {self.module_name(p): p for p in self.files}

    def read_doc(self, rel: str) -> str:
        """A non-scanned text file (docs), '' when absent."""
        full = os.path.join(self.root, rel)
        if not os.path.exists(full):
            return ""
        with open(full, encoding="utf-8") as f:
            return f.read()


def iter_module_scope(tree: ast.AST) -> Iterable[ast.AST]:
    """Nodes that execute at module import time: everything except the
    bodies of (async) function definitions and lambdas.  Class bodies,
    module-level ``if``/``try``/``with`` blocks all DO run at import."""
    stack = [tree]
    while stack:
        node = stack.pop()
        for child in ast.iter_child_nodes(node):
            yield child
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                stack.append(child)


# ---------------------------------------------------------------------------
# Baseline (suppression) protocol.
# ---------------------------------------------------------------------------

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: Optional[str] = None) -> Dict[Tuple[str, str], dict]:
    """(checker, key) → entry.  Raises ValueError on a malformed file or
    an entry without a nonempty reason — an unjustified suppression is
    itself a contract violation."""
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    out: Dict[Tuple[str, str], dict] = {}
    for entry in data.get("entries", []):
        checker = entry.get("checker")
        key = entry.get("key")
        reason = entry.get("reason", "")
        if not checker or not key:
            raise ValueError(f"baseline entry missing checker/key: {entry}")
        if not isinstance(reason, str) or not reason.strip():
            raise ValueError(
                f"baseline entry for {checker}:{key} has no reason — every "
                "suppression must justify itself"
            )
        out[(checker, key)] = entry
    return out


def write_baseline(findings: Sequence[Finding], path: Optional[str] = None,
                   reason: str = "grandfathered by --write-baseline — "
                   "replace with a real justification") -> None:
    path = path or BASELINE_PATH
    entries = [
        {"checker": f.checker, "key": f.key, "path": f.path,
         "reason": reason, "message": f.message}
        for f in sorted(findings, key=lambda f: (f.checker, f.key))
    ]
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"entries": entries}, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)


@dataclasses.dataclass
class LintResult:
    new: List[Finding]
    suppressed: List[Finding]
    stale_baseline: List[dict]          # entries matching no finding

    @property
    def ok(self) -> bool:
        return not self.new


def apply_baseline(findings: Sequence[Finding],
                   baseline: Dict[Tuple[str, str], dict]) -> LintResult:
    new, suppressed = [], []
    seen = set()
    for f in findings:
        ident = (f.checker, f.key)
        if ident in baseline:
            seen.add(ident)
            suppressed.append(f)
        else:
            new.append(f)
    stale = [entry for ident, entry in sorted(baseline.items())
             if ident not in seen]
    return LintResult(new=new, suppressed=suppressed, stale_baseline=stale)


# ---------------------------------------------------------------------------
# Runner.
# ---------------------------------------------------------------------------

def run_checkers(repo: Repo,
                 checkers: Dict[str, Callable[[Repo], List[Finding]]],
                 only: Optional[Sequence[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for name, fn in checkers.items():
        if only and name not in only:
            continue
        findings.extend(fn(repo))
    findings.extend(repo.parse_failures)
    return sorted(findings, key=lambda f: (f.path, f.line, f.checker, f.key))
