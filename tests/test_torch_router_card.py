"""The replica fleet on the card (marked ``gpu``, skipped without one; no JAX
import, so it runs where JAX is absent): ``serving/router.ServingFleet``
with 2 replicas started with ``--device cuda`` (a float32 mlp over
chain:6, 1 intra-op thread each) behind its router.

* Each replica holds a context on the card and this process, the
  router's, holds none: the card's contexts (nvidia-smi's compute-app
  rows; in a container their pids can all read the same) grow by 2 while
  the fleet serves, before the kill and after the respawn.
* Every reply's q equals a CPU forward of the published params within 1e-4
  of the largest |q| (float32; cuBLAS's TF32 is off by default).
* The next publish reaches both replicas as a page delta; after a SIGKILL
  the respawned replica full-syncs the newest version on the card.

Run it where a card is:
``python -m pytest --noconftest -m gpu tests/test_torch_router_card.py``.
"""

from __future__ import annotations

import os
import subprocess
import time

import numpy as np
import pytest
import torch

from ape_x_dqn_tpu_torch.config import ApexConfig, apply_overrides
from ape_x_dqn_tpu_torch.runtime.process_actors import network_and_template
from ape_x_dqn_tpu_torch.serving.net_server import ServingClient
from ape_x_dqn_tpu_torch.serving.router import ServingFleet

CFG = ["network=mlp", "env.name=chain:6", "serving.max_wait_ms=1.0",
       "serving.reload_poll_s=0.05"]
DEADLINE_S = 60.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _contexts() -> int:
    res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return sum(1 for ln in res.stdout.splitlines() if ln.strip())


def _until(cond, what: str, timeout: float = DEADLINE_S):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


@pytest.mark.gpu
def test_replica_fleet_serves_on_the_card(cuda_device):
    cfg = apply_overrides(ApexConfig(), CFG)
    obs_shape, net, template = network_and_template(cfg)
    g = torch.Generator().manual_seed(0)
    p1 = {k: torch.randn(v.shape, generator=g) * 0.1 for k, v in template.items()}
    p2 = {k: v + 0.25 if k.endswith("bias") else v.clone() for k, v in p1.items()}
    obs = np.random.default_rng(0).integers(0, 255, (4, *obs_shape), dtype=np.uint8)

    def cpu_q(params):
        with torch.no_grad():
            return net.apply_params(params, torch.from_numpy(obs)).q.numpy()

    before = _contexts()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    fleet = ServingFleet(replicas=2, probe_interval_s=0.25, env=env,
                         replica_args=["--device", "cuda",
                                       *(a for ov in CFG for a in ("--set", ov))])
    fleet.publish(p1)
    client = None
    try:
        fleet.start(timeout=240.0)
        client = ServingClient("127.0.0.1", fleet.port)
        for version, params in ((1, p1), (2, p2)):
            if version == 2:
                push = fleet.publish(p2)
                assert (push["delta"], push["full"]) == (2, 0)
            want = cpu_q(params)
            for rid, rep in fleet.replicas.items():
                c = ServingClient("127.0.0.1", rep.port, seed=rid)
                try:
                    _until(lambda: c.act(obs[0], timeout=DEADLINE_S).param_version == version,
                           f"replica {rid} at version {version}")
                    q = np.stack([c.act(o, timeout=DEADLINE_S).q_values for o in obs])
                finally:
                    c.close()
                assert np.abs(q - want).max() <= 1e-4 * np.abs(want).max(), (rid, version)
        assert _contexts() == before + 2
        victim = fleet.replicas[0].pid
        fleet.replicas[0].kill()
        assert client.act(obs[0], timeout=DEADLINE_S).param_version == 2
        _until(lambda: fleet.respawns == 1 and fleet.replicas[0].alive()
               and fleet.router.stats()["endpoints"]["0"]["healthy"]
               and (fleet.replicas[0].varz() or {}).get("serving", {}).get("param_version") == 2,
               "the respawn", timeout=240.0)
        assert fleet.replicas[0].pid != victim and _contexts() == before + 2
    finally:
        if client is not None:
            client.close()
        fleet.stop()
