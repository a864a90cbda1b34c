"""Shared pieces of the port's tests.

``port_deadline``: an autouse fixture that every ``tests/test_torch_*.py``
imports.  It arms a per-test deadline (``DEADLINE_S``, or the seconds of a
``@pytest.mark.deadline(s)`` on the test) with ``signal.setitimer`` in the
main thread, where lock waits, joins, sleeps and socket reads are
interruptible.  On expiry it writes every thread's stack to the run's
stderr, SIGKILLs the test's child processes and raises
``DeadlineExceeded`` in the test, which then fails with its name and the
deadline; the run goes on with the next test.  A teardown that outlives
the expiry by ``GRACE_S`` is interrupted the same way.  A main thread that
cannot be interrupted at all (stuck inside native code) gets its stacks
dumped by ``faulthandler`` ``GRACE_S`` later, and its worker is left
alive: a worker that exits stalled a ``--dist loadfile`` run just the
same (pytest-xdist 3.8 gave its requeued file to no replacement).  The fixture also holds
torch's intra-op threads to this xdist worker's share of the cores for
the test, so that six workers do not each run a pool the size of the
machine.

``worker_cores(k)``: the cores a test pins itself (and the children it
spawns, which inherit them) to.  Under pytest-xdist each worker takes its
own pair, by its index (``PYTEST_XDIST_WORKER`` = ``gw<i>``), so pinned
tests on different workers do not all share the first two cores.

``bounded_teardown(*steps)``: run each (name, fn) teardown step with a
bound of its own.  A step that outlives its bound is left to its daemon
thread, every child process of this process still alive is SIGKILLed, and
the test fails naming the step, instead of holding its worker until the
suite's time limit.

``joined(thread, timeout_s, what)`` and ``readline_within(stream,
timeout_s, what)``: a join and a line of a child's pipe with a bound,
failing with what they waited for.  ``learner_waits_for_workers(pipe,
n)``: a pipeline's learner starts once every process worker has fed it.
"""

from __future__ import annotations

import contextlib
import faulthandler
import os
import signal
import sys
import threading
import time

import pytest

# The default per-test deadline: 5x the slowest port test of a run of the
# whole suite under `taskset -c 0-2` (-n 6), and at most 300 s.  A test
# that needs longer names its own seconds with @pytest.mark.deadline(s),
# beside the time it was measured at.
DEADLINE_S = 300.0
# After an expiry: the bound on the test's teardown, then the stack dump
# of a thread that no signal could interrupt.
GRACE_S = 30.0


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


def kill_children() -> list:
    """SIGKILL every live child process of this process; their pids."""
    killed = _children()
    for pid in killed:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    return killed


class DeadlineExceeded(BaseException):
    """Raised in a test that outlived its deadline.  A BaseException, so
    that no ``except Exception`` of the test or the port swallows it."""


_stderr = None


def _real_stderr(config):
    """A file on the run's own stderr, past pytest's capture of the test."""
    global _stderr
    if _stderr is None:
        capman = config.pluginmanager.getplugin("capturemanager")
        with capman.global_and_fixture_disabled() if capman else contextlib.nullcontext():
            _stderr = os.fdopen(os.dup(2), "w", buffering=1)
    return _stderr


def _torch_threads_share():
    """torch's intra-op threads for this xdist worker: its share of the
    cores, or None outside xdist or before torch is imported."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if not workers or "torch" not in sys.modules:
        return None
    return max(1, len(os.sched_getaffinity(0)) // workers)


@pytest.fixture(autouse=True)
def port_deadline(request):
    """The per-test deadline of the module docstring."""
    mark = request.node.get_closest_marker("deadline")
    seconds = float(mark.args[0]) if mark else DEADLINE_S
    name = request.node.nodeid
    err = _real_stderr(request.config)

    def expire(_signum, _frame):
        err.write(f"\n{name} outlived its deadline of {seconds} s; every thread's stack:\n")
        err.flush()
        faulthandler.dump_traceback(file=err, all_threads=True)
        killed = kill_children()
        err.write(f"{name}: SIGKILLed child pids {killed}\n")
        err.flush()
        signal.setitimer(signal.ITIMER_REAL, GRACE_S)   # again if the teardown hangs
        raise DeadlineExceeded(f"{name} outlived its deadline of {seconds} s")

    share = _torch_threads_share()
    if share is not None:
        torch = sys.modules["torch"]
        threads = torch.get_num_threads()
        torch.set_num_threads(share)
    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    faulthandler.dump_traceback_later(seconds + 2 * GRACE_S, file=err)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, prev)
        if share is not None:
            torch.set_num_threads(threads)


def joined(thread, timeout_s: float, what: str) -> None:
    """Join ``thread`` within ``timeout_s``, else fail naming ``what``."""
    thread.join(timeout_s)
    if thread.is_alive():
        raise AssertionError(f"{what} still running after {timeout_s} s")


def readline_within(stream, timeout_s: float, what: str):
    """One line of a child's pipe within ``timeout_s``, else fail naming
    ``what``.  The read runs on a daemon thread (a line already buffered by
    the stream is not seen by select), which the child's end releases."""
    line = []
    t = threading.Thread(target=lambda: line.append(stream.readline()), daemon=True)
    t.start()
    t.join(timeout_s)
    if not line:
        raise AssertionError(f"no line from {what} within {timeout_s} s")
    return line[0]


def learner_waits_for_workers(pipe, n: int, timeout_s: float = 120.0) -> None:
    """Hold ``pipe``'s learner, after its replay warm-up, until each of its
    ``n`` process workers has landed a chunk (within ``timeout_s``): on a
    loaded machine one spawned worker can start after the others have
    filled the warm-up and the run's steps have gone by."""
    warmup = pipe._wait_for_warmup

    def wait(timeout):
        warmup(timeout)
        deadline = time.monotonic() + timeout_s
        while len(pipe.worker.pool.last_versions) < n:
            if time.monotonic() >= deadline:
                raise AssertionError(f"only workers {sorted(pipe.worker.pool.last_versions)} "
                                     f"of {n} fed the learner within {timeout_s} s")
            time.sleep(0.05)
            warmup(timeout)   # with device replay, this ingests the staged chunks

    pipe._wait_for_warmup = wait


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
            killed = kill_children()
            raise AssertionError(f"teardown step {name!r} outlived {timeout_s} s; "
                                 f"SIGKILLed child pids {killed}")
        if err:
            raise err[0]
