"""The port stands alone: importing every module of ``ape_x_dqn_tpu_torch``
loads no JAX, no flax/optax/cv2, and nothing of the JAX package."""

from __future__ import annotations

import json
import os
import pkgutil
import subprocess
import sys

import ape_x_dqn_tpu_torch

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
                 "ape_x_dqn_tpu_torch.runtime.async_pipeline"):
        assert want in mods


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
