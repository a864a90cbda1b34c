"""The port stands alone: importing every module of ``ape_x_dqn_tpu_torch``
loads no JAX, no flax/optax/cv2, and nothing of the JAX package."""

from __future__ import annotations

import json
import os
import pkgutil
import subprocess
import sys

import ape_x_dqn_tpu_torch

from _torch_harness import port_deadline  # noqa: F401 — the per-test deadline, autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "cv2", "ape_x_dqn_tpu")


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(ape_x_dqn_tpu_torch.__path__,
                                              prefix="ape_x_dqn_tpu_torch.")
    )


def test_port_modules_are_found():
    mods = _port_modules()
    for want in ("ape_x_dqn_tpu_torch.ops.sampling", "ape_x_dqn_tpu_torch.train",
                 "ape_x_dqn_tpu_torch.runtime.async_pipeline",
                 "ape_x_dqn_tpu_torch.replay.buffer", "ape_x_dqn_tpu_torch.replay.native",
                 "ape_x_dqn_tpu_torch.runtime.infeed",
                 "ape_x_dqn_tpu_torch.runtime.single_process",
                 "ape_x_dqn_tpu_torch.evaluation", "ape_x_dqn_tpu_torch.utils.profiling",
                 "ape_x_dqn_tpu_torch.runtime.process_actors",
                 "ape_x_dqn_tpu_torch.runtime.shm_ring",
                 "ape_x_dqn_tpu_torch.runtime.transport",
                 "ape_x_dqn_tpu_torch.runtime.supervisor",
                 "ape_x_dqn_tpu_torch.utils.serialization",
                 "ape_x_dqn_tpu_torch.utils.memory",
                 "ape_x_dqn_tpu_torch.replay.dedup",
                 "ape_x_dqn_tpu_torch.replay.device_dedup",
                 "ape_x_dqn_tpu_torch.runtime.fused_dedup",
                 "ape_x_dqn_tpu_torch.runtime.net",
                 "ape_x_dqn_tpu_torch.obs.lineage",
                 "ape_x_dqn_tpu_torch.obs.registry",
                 "ape_x_dqn_tpu_torch.obs.exporter",
                 "ape_x_dqn_tpu_torch.obs.shm_stats",
                 "ape_x_dqn_tpu_torch.obs.recorder",
                 "ape_x_dqn_tpu_torch.obs.trace",
                 "ape_x_dqn_tpu_torch.serving",
                 "ape_x_dqn_tpu_torch.serving.batcher",
                 "ape_x_dqn_tpu_torch.serving.server",
                 "ape_x_dqn_tpu_torch.serving.net_server",
                 "ape_x_dqn_tpu_torch.serving.central",
                 "ape_x_dqn_tpu_torch.serve",
                 "ape_x_dqn_tpu_torch.utils.checkpoint",
                 "ape_x_dqn_tpu_torch.utils.checkpoint_inc",
                 "ape_x_dqn_tpu_torch.serving.sources",
                 "ape_x_dqn_tpu_torch.profile_checkpoint",
                 "ape_x_dqn_tpu_torch.host_join",
                 "ape_x_dqn_tpu_torch.fleet",
                 "ape_x_dqn_tpu_torch.fleet.registry",
                 "ape_x_dqn_tpu_torch.serving.router",
                 "ape_x_dqn_tpu_torch.envs.atari",
                 "ape_x_dqn_tpu_torch.envs.fake_atari",
                 "ape_x_dqn_tpu_torch.obs.chaos",
                 "ape_x_dqn_tpu_torch.replay.tiered",
                 "ape_x_dqn_tpu_torch.replay.native_dedup",
                 "ape_x_dqn_tpu_torch.replay.service",
                 "ape_x_dqn_tpu_torch.obs.fleet",
                 "ape_x_dqn_tpu_torch.obs.timeline",
                 "ape_x_dqn_tpu_torch.autopilot",
                 "ape_x_dqn_tpu_torch.autopilot.controller",
                 "ape_x_dqn_tpu_torch.autopilot.actuators",
                 "ape_x_dqn_tpu_torch.parallel",
                 "ape_x_dqn_tpu_torch.parallel.mesh",
                 "ape_x_dqn_tpu_torch.parallel.dp",
                 "ape_x_dqn_tpu_torch.parallel.multihost",
                 "ape_x_dqn_tpu_torch.replay.device_dp",
                 "ape_x_dqn_tpu_torch.replay.device_dedup_dp",
                 "ape_x_dqn_tpu_torch.analysis",
                 "ape_x_dqn_tpu_torch.analysis.core",
                 "ape_x_dqn_tpu_torch.analysis.import_light",
                 "ape_x_dqn_tpu_torch.analysis.wire_registry",
                 "ape_x_dqn_tpu_torch.analysis.config_coverage",
                 "ape_x_dqn_tpu_torch.analysis.metrics_doc",
                 "ape_x_dqn_tpu_torch.analysis.shm_discipline",
                 "ape_x_dqn_tpu_torch.analysis.typed_errors",
                 "ape_x_dqn_tpu_torch.lint",
                 "ape_x_dqn_tpu_torch.__main__"):
        assert want in mods


def test_process_actor_modules_load_no_torch():
    """A spawned worker imports ``runtime.process_actors`` before its target
    runs and pays for everything it pulls in: stdlib + numpy only."""
    code = (
        "import json, sys\n"
        "import ape_x_dqn_tpu_torch.runtime.process_actors\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {(*FORBIDDEN, 'torch')!r})\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_network_plane_loads_no_torch():
    """The tcp transport's writer side (``runtime.net``, ``runtime.transport``)
    and the remote-worker launcher load stdlib + numpy only: a spawned
    worker and ``host_join`` import them before a child hides the card."""
    code = (
        "import json, sys\n"
        "import ape_x_dqn_tpu_torch.runtime.net\n"
        "import ape_x_dqn_tpu_torch.runtime.transport\n"
        "import ape_x_dqn_tpu_torch.host_join\n"
        "from ape_x_dqn_tpu_torch.host_join import build_argparser\n"
        "build_argparser().parse_args(['--join', 'x.json', '--host', '10.0.0.2'])\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {(*FORBIDDEN, 'torch')!r})\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_serving_wire_modules_load_no_torch():
    """A central worker dials the server through ``serving.central`` (and
    the wire, batcher, socket server and trace logs beside it), and the
    fleet's router and registry run in processes that serve no forward:
    stdlib + numpy only, like the process-actor module."""
    code = (
        "import json, sys\n"
        "import ape_x_dqn_tpu_torch.serving.central\n"
        "import ape_x_dqn_tpu_torch.serving.net_server\n"
        "import ape_x_dqn_tpu_torch.serving.router\n"
        "import ape_x_dqn_tpu_torch.fleet.registry\n"
        "import ape_x_dqn_tpu_torch.fleet\n"
        "import ape_x_dqn_tpu_torch.serving\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {(*FORBIDDEN, 'torch')!r})\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_obs_worker_modules_load_neither_torch_nor_jax():
    """A worker writes its stats block and flight recorder before it
    imports torch, and the registry is plain Python: the three load the
    standard library only (the lazy ``obs`` package pulls in no exporter
    or trace)."""
    code = (
        "import json, sys\n"
        "import ape_x_dqn_tpu_torch.obs.shm_stats\n"
        "import ape_x_dqn_tpu_torch.obs.recorder\n"
        "import ape_x_dqn_tpu_torch.obs.registry\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {(*FORBIDDEN, 'torch', 'numpy')!r}\n"
        "             or n in ('ape_x_dqn_tpu_torch.obs.exporter',\n"
        "                      'ape_x_dqn_tpu_torch.obs.trace'))\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_atari_envs_and_chaos_load_no_torch_cv2_or_gymnasium():
    """The Atari stack, the fake emulator and the chaos injector run in
    worker children (``SlowEnv`` wraps their envs) and in the monkey's
    thread, which never touches the card: stdlib + numpy only, as their
    JAX twins, and no cv2 or gymnasium until a gym env is built."""
    code = (
        "import json, sys\n"
        "import ape_x_dqn_tpu_torch.envs.atari\n"
        "import ape_x_dqn_tpu_torch.envs.fake_atari\n"
        "import ape_x_dqn_tpu_torch.obs.chaos\n"
        "from ape_x_dqn_tpu_torch.envs import make_env\n"
        "make_env('fake-atari').step(0)\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {(*FORBIDDEN, 'torch', 'gymnasium')!r})\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_fleet_timeline_and_autopilot_load_neither_torch_nor_jax():
    """The aggregator, the timeline store and the autopilot are operator
    tools that come up in milliseconds on any host: stdlib only at import
    (as their JAX twins), and a sweep over an in-process endpoint, a
    timeline append and a controller step load no torch, no numpy and
    nothing of JAX or of the JAX package."""
    code = (
        "import json, sys, tempfile\n"
        "import ape_x_dqn_tpu_torch.obs.fleet as fleet\n"
        "import ape_x_dqn_tpu_torch.obs.timeline as timeline\n"
        "import ape_x_dqn_tpu_torch.autopilot as ap\n"
        "from ape_x_dqn_tpu_torch.autopilot import (ActorPoolActuator, AutopilotController,\n"
        "    ReplayFleetActuator, ServingFleetActuator)\n"
        "from ape_x_dqn_tpu_torch.config import AutopilotConfig\n"
        "agg = fleet.FleetAggregator()\n"
        "agg.attach_timeline(timeline.TimelineStore(tempfile.mkdtemp()))\n"
        "agg.add_local('trainer', lambda: {'learner': {'step': 1}})\n"
        "agg.scrape_once(now=1.0)\n"
        "AutopilotController(AutopilotConfig(enabled=True), rollup_fn=agg.rollup).step(now=1.0)\n"
        "agg.close()\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {(*FORBIDDEN, 'torch', 'numpy')!r})\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_checkpoint_chunk_reader_loads_no_torch():
    """Reading an APXC chunk or manifest (restore tooling, a killed
    writer's inspection) pays for stdlib + numpy only."""
    code = (
        "import json, sys\n"
        "import ape_x_dqn_tpu_torch.utils.checkpoint_inc\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {(*FORBIDDEN, 'torch')!r})\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_tiered_store_loads_neither_torch_nor_jax():
    """The tiered frame store runs in kill-test children and restore tooling,
    as its JAX twin does: stdlib + numpy only (the lazy ``replay`` package
    imports no buffer, and so no torch)."""
    code = (
        "import json, sys\n"
        "import ape_x_dqn_tpu_torch.replay.tiered\n"
        "from ape_x_dqn_tpu_torch.replay.tiered import ColdSpanStore, TierEvictor\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {(*FORBIDDEN, 'torch')!r})\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_host_dedup_replays_load_no_jax():
    """The host dedup replay and its native core load no jax and nothing of
    the JAX package (their C++ core is the port's own copy)."""
    code = (
        "import json, sys\n"
        "import ape_x_dqn_tpu_torch.replay.dedup\n"
        "import ape_x_dqn_tpu_torch.replay.native_dedup as nd\n"
        "from ape_x_dqn_tpu_torch.replay import DedupReplay\n"
        "assert nd.SOURCE.parent.parent.name == 'ape_x_dqn_tpu_torch'\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_data_parallel_modules_load_no_jax():
    """The mesh, the data-parallel step, the process group and the sharded
    rings load no jax and nothing of the JAX package, and lay a ring out
    over a CPU mesh without them."""
    code = (
        "import json, sys\n"
        "import ape_x_dqn_tpu_torch.parallel as par\n"
        "import ape_x_dqn_tpu_torch.parallel.multihost\n"
        "import ape_x_dqn_tpu_torch.replay.device_dp as ddp\n"
        "import ape_x_dqn_tpu_torch.replay.device_dedup_dp as dddp\n"
        "mesh = par.make_mesh(devices=['cpu'] * 2)\n"
        "assert ddp.init_sharded_device_replay(8, (4,), mesh).n == 2\n"
        "assert dddp.init_sharded_dedup_replay(8, (4,), mesh).n == 2\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_analysis_and_lint_load_the_standard_library_only():
    """The port's apexlint is stdlib only, as its JAX twin: importing the
    checkers and the CLI, and linting the port, load no torch, no numpy and
    nothing of JAX or of the JAX package."""
    code = (
        "import json, sys\n"
        "import ape_x_dqn_tpu_torch.analysis as analysis\n"
        "import ape_x_dqn_tpu_torch.lint\n"
        "findings = analysis.run_all(analysis.Repo('.'), only=['typed-errors'])\n"
        "assert findings == [], findings\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {(*FORBIDDEN, 'torch', 'numpy')!r})\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_importing_the_port_loads_no_jax():
    mods = ["ape_x_dqn_tpu_torch", *_port_modules()]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_no_jax():
    code = (
        "import sys, json; sys.argv = ['chip_smoke']\n"
        "import chip_smoke\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_replay_service_and_shard_main_load_no_jax(tmp_path):
    """``replay/service.py`` imports stdlib + numpy and the port's codecs
    only, and the shard CLI's whole life (parse, restore, serve under RPC
    chaos, stop) loads no torch and nothing of JAX or of the JAX package:
    a shard is a CPU process that spawns in about a second (the JAX shard
    reaches jax through ``replay/buffer.py`` → ``types.py``)."""
    code = (
        "import json, os, signal, sys, threading\n"
        "from ape_x_dqn_tpu_torch.replay import service\n"
        "at_import = sorted(n for n in sys.modules\n"
        f"                   if n.split('.')[0] in {(*FORBIDDEN, 'torch')!r})\n"
        "emit = service._emit_line\n"
        "def line(**f):\n"
        "    emit(**f)\n"
        "    if f.get('event') == 'replay_shard_listen':\n"
        "        threading.Timer(0.3, os.kill, (os.getpid(), signal.SIGTERM)).start()\n"
        "service._emit_line = line\n"
        "rc = service.main(['--shard-id', '0', '--capacity', '64', '--obs-shape', '6',\n"
        f"                   '--ckpt-dir', {str(tmp_path)!r}, '--rpc-drop-rate', '0.1'])\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {(*FORBIDDEN, 'torch')!r})\n"
        "print(json.dumps({'rc': rc, 'at_import': at_import, 'bad': bad}))\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"rc": 0, "at_import": [], "bad": []}
    events = [json.loads(x)["event"] for x in lines[:-1]]
    assert events[0] == "replay_shard_listen" and events[-1] == "replay_shard_stopped"
