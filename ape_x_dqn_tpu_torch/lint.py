"""apexlint CLI for the port — run the static invariant checkers over
``ape_x_dqn_tpu_torch``.

Usage (from the repo root):

    python -m ape_x_dqn_tpu_torch.lint                 # human report; exit 1 on NEW findings
    python -m ape_x_dqn_tpu_torch.lint --json          # machine-readable (obs tooling)
    python -m ape_x_dqn_tpu_torch.lint --only wire-registry,typed-errors
    python -m ape_x_dqn_tpu_torch.lint --write-baseline  # grandfather current findings

Port of ``tools/lint.py``, with the same flags and exit codes: 0 when
clean, 1 on a finding that the baseline does not list, 2 on a malformed
baseline (an entry without a reason among them).  The committed
suppression file is ``ape_x_dqn_tpu_torch/analysis/baseline.json``;
every entry must carry a reason (``--fail-on-new`` is the default and
the flag exists only to make a gate's intent explicit).  Stale baseline
entries (suppressing nothing) are reported so the file shrinks over
time.  ``--json`` also lists the ids of the checkers that ran.

A static analysis touches no device, so this entry point takes no
``--device``.  The checker table and what to do on a finding: the
docstring of ``ape_x_dqn_tpu_torch.analysis``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ape_x_dqn_tpu_torch import analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ape_x_dqn_tpu_torch.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", default=REPO,
                        help="repo root to scan (default: this checkout)")
    parser.add_argument("--baseline", default=None,
                        help="suppression file (default: "
                             "ape_x_dqn_tpu_torch/analysis/baseline.json)")
    parser.add_argument("--only", default=None,
                        help="comma-separated checker ids to run")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit findings as JSON for obs tooling")
    parser.add_argument("--fail-on-new", action="store_true",
                        help="exit nonzero on findings outside the "
                             "baseline (this is already the default; the "
                             "flag documents the gate's intent)")
    parser.add_argument("--no-fail", action="store_true",
                        help="always exit 0 (report-only sweeps)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write current findings to the baseline with "
                             "placeholder reasons (edit them before "
                             "committing)")
    args = parser.parse_args(argv)

    t0 = time.monotonic()
    repo = analysis.Repo(args.root)
    only = args.only.split(",") if args.only else None
    if only:
        unknown = set(only) - set(analysis.CHECKERS)
        if unknown:
            parser.error(f"unknown checker ids: {sorted(unknown)} "
                         f"(have: {sorted(analysis.CHECKERS)})")
    findings = analysis.run_all(repo, only=only)

    if args.write_baseline:
        path = args.baseline or analysis.BASELINE_PATH
        analysis.write_baseline(findings, path=path)
        print(f"wrote {len(findings)} entries to {path} — edit the "
              "placeholder reasons before committing")
        return 0

    try:
        baseline = analysis.load_baseline(args.baseline)
    except ValueError as e:
        print(f"BASELINE ERROR: {e}", file=sys.stderr)
        return 2
    result = analysis.apply_baseline(findings, baseline)
    elapsed_ms = (time.monotonic() - t0) * 1e3

    if args.as_json:
        print(json.dumps({
            "checkers": [c for c in analysis.CHECKERS
                         if not only or c in only],
            "files_scanned": len(repo.files),
            "elapsed_ms": round(elapsed_ms, 1),
            "new": [f.as_dict() for f in result.new],
            "suppressed": [f.as_dict() for f in result.suppressed],
            "stale_baseline": result.stale_baseline,
            "ok": result.ok,
        }, indent=2))
    else:
        for f in result.new:
            print(f.render())
        if result.suppressed:
            print(f"# {len(result.suppressed)} finding(s) suppressed by "
                  "baseline (each with a committed reason)")
        for entry in result.stale_baseline:
            print(f"# stale baseline entry (suppresses nothing): "
                  f"{entry['checker']}:{entry['key']} — consider removing")
        verdict = "clean" if result.ok else f"{len(result.new)} NEW finding(s)"
        print(f"# apexlint: {verdict} — {len(repo.files)} files, "
              f"{elapsed_ms:.0f} ms")
    if args.no_fail:
        return 0
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
