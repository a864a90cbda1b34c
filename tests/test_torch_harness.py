"""The port's per-test deadline (``_torch_harness.port_deadline``), seen
from outside: a child pytest runs a file whose first test blocks forever
under a 2 s deadline, and the run must fail that test with every thread's
stack, SIGKILL what it spawned and go on to pass the tests after it."""

import os
import re
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import pytest

from _torch_harness import port_deadline  # noqa: F401 — the deadline, autouse

HERE = os.path.dirname(os.path.abspath(__file__))

_CHILD = '''
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from _torch_harness import port_deadline  # noqa: F401

PID_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "spawned.pid")


@pytest.mark.deadline(2)
def test_blocks_forever():
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
    with open(PID_FILE, "w") as f:
        f.write(str(child.pid))
    threading.Event().wait()


def test_next_test_runs_and_the_spawned_process_is_gone():
    pid = int(open(PID_FILE).read())
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        state = "gone"
    assert state in ("Z", "gone"), state


@pytest.mark.deadline(2)
def test_under_its_deadline_is_untouched():
    time.sleep(0.5)
    assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= 1.5


def test_an_unmarked_test_gets_the_default_deadline():
    assert 250 < signal.getitimer(signal.ITIMER_REAL)[0] <= 300
'''


@pytest.mark.parametrize("dist", ["plain", "xdist"])
def test_a_test_that_blocks_forever_fails_at_its_deadline_and_the_run_goes_on(tmp_path, dist):
    (tmp_path / "test_child.py").write_text(_CHILD)
    (tmp_path / "pytest.ini").write_text(
        "[pytest]\nmarkers =\n    deadline(seconds): the test's own deadline\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    xml = tmp_path / "child.xml"
    args = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
            f"--junitxml={xml}", "test_child.py"]
    if dist == "xdist":
        args[4:4] = ["-p", "xdist", "-n", "1"]
    t0 = time.monotonic()
    res = subprocess.run(args, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    wall = time.monotonic() - t0
    log = res.stdout + res.stderr
    assert res.returncode == 1, log
    cases = {c.get("name"): c for c in ET.parse(xml).getroot().iter("testcase")}
    failed = cases["test_blocks_forever"]
    assert failed.find("failure") is not None, log
    assert float(failed.get("time")) < 15.0, (failed.get("time"), log)
    assert "test_child.py::test_blocks_forever outlived its deadline of 2.0 s" in log
    # every thread's stack, the blocked test's own frame among them
    assert "Current thread" in log and 'in test_blocks_forever' in log, log
    assert re.search(r"SIGKILLed child pids \[\d+\]", log), log
    for name in ("test_next_test_runs_and_the_spawned_process_is_gone",
                 "test_under_its_deadline_is_untouched",
                 "test_an_unmarked_test_gets_the_default_deadline"):
        assert cases[name].find("failure") is None and cases[name].find("error") is None, log
    assert "1 failed, 3 passed" in res.stdout, log
    assert wall < 60.0, wall
