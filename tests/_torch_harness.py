"""Shared pieces of the port's process-spawning tests.

``worker_cores(k)``: the cores a test pins itself (and the children it
spawns, which inherit them) to.  Under pytest-xdist each worker takes its
own pair, by its index (``PYTEST_XDIST_WORKER`` = ``gw<i>``), so pinned
tests on different workers do not all share the first two cores.

``bounded_teardown(*steps)``: run each (name, fn) teardown step with a
bound of its own.  A step that outlives its bound is left to its daemon
thread, every child process of this process still alive is SIGKILLed, and
the test fails naming the step, instead of holding its worker until the
suite's time limit.
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading


def worker_cores(k: int = 2) -> list:
    """``k`` of this process's cores, chosen by the xdist worker index."""
    cores = sorted(os.sched_getaffinity(0))
    wid = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    i = int(wid[2:]) if wid[2:].isdigit() else 0
    start = (i * k) % max(len(cores) - k + 1, 1)
    return cores[start:start + k]


@contextlib.contextmanager
def pinned_cores(k: int = 2):
    """Pin this process to ``worker_cores(k)`` for the block."""
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, worker_cores(k))
    try:
        yield
    finally:
        os.sched_setaffinity(0, cores)


def _children() -> list:
    me = str(os.getpid())
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[1] == me and fields[0] != "Z":
            out.append(int(pid))
    return out


def bounded_teardown(*steps, timeout_s: float = 60.0) -> None:
    """Run ``steps`` ((name, fn) pairs) in order, each within ``timeout_s``;
    on the first that overruns, SIGKILL this process's children and raise."""
    for name, fn in steps:
        err = []

        def run(fn=fn, err=err):
            try:
                fn()
            except BaseException as e:   # re-raised on the test's thread below
                err.append(e)

        t = threading.Thread(target=run, name=f"teardown-{name}", daemon=True)
        t.start()
        t.join(timeout_s)
        if t.is_alive():
            killed = _children()
            for pid in killed:
                with contextlib.suppress(OSError):
                    os.kill(pid, signal.SIGKILL)
            raise AssertionError(f"teardown step {name!r} outlived {timeout_s} s; "
                                 f"SIGKILLed child pids {killed}")
        if err:
            raise err[0]
