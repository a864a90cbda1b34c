"""Run one cell of the benchmark once, on the card this process sees:

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

The last line of standard output is the result's JSON object; earlier
lines carry the set-up split, the card's clocks and power around the
window and the reference's time (also written to
``build/benchmark/<workload>.<seed>.<trace>.run.json``), and the last
lines of standard error each number the check compared beside its limit.
Exits 2 without a result when no CUDA device (or fewer than the cell
asks for) is visible, 1 when the run cannot finish.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    only a cell's first run in a checkout builds; the profiler's settings
    for CUDA graphs (see ``harness._Profiler``)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.join(root, "build", "benchmark", "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TEARDOWN_CUPTI"] = "0"
    os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
    os.environ["KINETO_CONFIG"] = os.path.join(root, "benchmark", "kineto.conf")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    from benchmark.harness import BenchmarkError, load_cell, run_cell

    cell = load_cell(args.workload)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark.run: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    try:
        run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                 t_process=T_PROCESS, out=lambda s: print(s, flush=True))
    except BenchmarkError as e:
        print(f"benchmark.run: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
