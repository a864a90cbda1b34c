"""apexlint for the port — static analysis of this package's invariants.

Port of ``ape_x_dqn_tpu/analysis``: the same six checkers, aimed at
``ape_x_dqn_tpu_torch`` (every path, module and contract they check is in
``core.py``).  Each is derived from a contract the package already states
in prose (docstrings, docs/METRICS.md, the leak guard, the adversarial-
decode tests):

  ==================  =====================================================
  checker id          contract
  ==================  =====================================================
  import-light        contracted child-process modules never reach torch
                      (or jax, flax, optax, ...) through any transitive
                      module-scope import (static module-graph walk incl.
                      package ``__init__`` chains)
  wire-registry       every ``F_*`` frame kind / protocol magic declared
                      once in runtime/net.py, unique, no duplicated
                      literals at decode sites
  config-coverage     every ``cfg.<section>.<knob>`` read resolves to a
                      declared field; every declared knob is documented
  metrics-doc         every literal registry instrument / provider /
                      JSONL-section name appears in docs/METRICS.md
  shm-discipline      SharedMemory creation flows through the
                      session-prefix helpers (leak-guard attribution)
  typed-errors        no bare ``except:``; silent broad swallows carry an
                      in-place ``# noqa: BLE001 — reason``
  ==================  =====================================================

What to do when a checker fires:

  import-light        move the heavy import into the function that needs
                      it, or break the chain (a package ``__init__`` that
                      imports a heavy submodule eagerly is the usual one)
  wire-registry       declare the kind or magic once in runtime/net.py and
                      import the name; compare kinds against the ``F_*``
                      name; give a dispatch an explicit reject path
  config-coverage     fix the read to a declared field, or declare it in
                      config.py; document a new knob as ``section.knob``
                      in the README's port section
  metrics-doc         document the name in backticks in docs/METRICS.md
                      (a name only the port has: in the README's port
                      section, which the checker reads too)
  shm-discipline      mint the segment through
                      ``shm_ring.create_shared_memory``
  typed-errors        name the exception type, surface the failure, or add
                      ``# noqa: BLE001 — <why best-effort is right here>``

A finding that is right as it stands goes into ``baseline.json`` with a
reason.  Run ``python -m ape_x_dqn_tpu_torch.lint``.  The package is
import-light by its own contract: stdlib only.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from ape_x_dqn_tpu_torch.analysis import (
    config_coverage,
    import_light,
    metrics_doc,
    shm_discipline,
    typed_errors,
    wire_registry,
)
from ape_x_dqn_tpu_torch.analysis.core import (
    BASELINE_PATH,
    Finding,
    LintResult,
    Repo,
    apply_baseline,
    load_baseline,
    run_checkers,
    write_baseline,
)

#: checker id -> Repo -> findings (production defaults; tests call the
#: modules' ``check`` directly with fixture options).
CHECKERS: Dict[str, Callable[[Repo], List[Finding]]] = {
    import_light.CHECKER: import_light.check,
    wire_registry.CHECKER: wire_registry.check,
    config_coverage.CHECKER: config_coverage.check,
    metrics_doc.CHECKER: metrics_doc.check,
    shm_discipline.CHECKER: shm_discipline.check,
    typed_errors.CHECKER: typed_errors.check,
}


def run_all(repo: Repo, only=None) -> List[Finding]:
    return run_checkers(repo, CHECKERS, only=only)


__all__ = [
    "BASELINE_PATH",
    "CHECKERS",
    "Finding",
    "LintResult",
    "Repo",
    "apply_baseline",
    "load_baseline",
    "run_all",
    "write_baseline",
]
