"""Serving round trips on the card beside the learner, case by case.

    python -m ape_x_dqn_tpu_torch.profile_serving [--seconds S]

A ``PolicyServer`` (full-width conv dueling net, bf16, max_batch 32,
max_wait 0.2 ms) serves one closed-loop client that sends 8 rows at a
time, while a learner of the port runs graphed fused calls on a thread of
its own in the same process (no actors, no sockets: the device and the
interpreter are shared, nothing else).  Cases, each for ``--seconds``:

  * ``idle``              — no learner;
  * ``dedup_paced``       — config3's learner (a full 2M-slot dedup ring
    filled on the card from a seed, sample-ahead K = 2048, bf16 ν and
    target), its replays paced to ``graphed_call.MAX_REPLAYS_AHEAD`` in
    flight (the runner's default);
  * ``dedup_unpaced``     — the same with the pacing off (0): the host
    issues replays until CUDA's launch queue is full;
  * ``double_strict`` / ``double_sample_ahead`` — the double-store ring of
    100 000 slots, K = 128, paced: one cooperative sampler launch per step
    against one per call.

Then ``serve --attach`` (``serve.main``) with phase 5's device-replay
learner of ``chip_smoke.py`` and 4 in-process clients, its actors as a
thread in the learner's process against 2 worker processes.

Prints one JSON line per case: the round trip's count, p50 and p99 (ms),
the server's per-bucket host and device ms (``forward_times``) and the
learner's steps/s; the first line is the card's name and power limit
(``nvidia-smi``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import threading
import time

import numpy as np
import torch

OBS = (84, 84, 1)


def _pct(values, p):
    return round(float(np.percentile(values, p)), 3) if values else None


def _learners(dev, gen):
    """(network, state, {case: (call, ring)}): both layouts over one train
    state, rings filled as ``profile_fused`` fills them."""
    from ape_x_dqn_tpu_torch.learner.train_step import (
        build_train_step,
        init_train_state,
        make_optimizer,
    )
    from ape_x_dqn_tpu_torch.models.dueling import build_network
    from ape_x_dqn_tpu_torch.profile_fused import _fill_dedup, _fill_double
    from ape_x_dqn_tpu_torch.replay.device import init_device_replay
    from ape_x_dqn_tpu_torch.replay.device_dedup import (
        dedup_sample_many,
        init_dedup_device_replay,
    )
    from ape_x_dqn_tpu_torch.runtime.graphed_call import GraphedCall

    net = build_network("conv", 3, OBS)
    opt = make_optimizer("rmsprop", second_moment_dtype=torch.bfloat16)
    state = init_train_state(net, opt, device=dev, target_dtype=torch.bfloat16)
    step = build_train_step(net, opt, sync_in_step=False)
    dedup = init_dedup_device_replay(2_000_000, OBS, frame_ratio=1.25, device=dev)
    _fill_dedup(dedup, gen)
    double = init_device_replay(100_000, OBS, device=dev)
    _fill_double(double, gen)
    knobs = dict(batch_size=32, priority_exponent=0.6, target_sync_freq=2048)
    calls = {
        "dedup": (GraphedCall(step, steps_per_call=2048, sample_ahead=True,
                              sample_many_fn=dedup_sample_many, **knobs), dedup),
        "double_strict": (GraphedCall(step, steps_per_call=128, sample_ahead=False,
                                      **knobs), double),
        "double_sample_ahead": (GraphedCall(step, steps_per_call=128, sample_ahead=True,
                                            **knobs), double),
    }
    for call, ring in calls.values():
        call.bind(state, ring)
    return net, state, calls


def _case(name, server, learn, seconds: float) -> dict:
    """Closed-loop 8-row requests for ``seconds`` (or until ``learn``, run
    on a thread, returns); the learner's steps/s beside them."""
    obs = np.random.default_rng(0).integers(0, 256, (8, *OBS), dtype=np.uint8)
    info: dict = {}
    stop = threading.Event()
    if learn is not None:
        def run():
            info["steps_per_s"] = learn(seconds)
            stop.set()

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
    with server._times_lock:
        server._times.clear()
    rtts = []
    end = time.monotonic() + seconds
    while time.monotonic() < end and not stop.is_set():
        t0 = time.monotonic()
        for f in [server.submit(o) for o in obs]:
            f.result(timeout=120)
        rtts.append((time.monotonic() - t0) * 1e3)
    if learn is not None:
        thread.join(300)
    return {"case": name, "rtt_ms": {"count": len(rtts), "p50": _pct(rtts, 50),
                                     "p99": _pct(rtts, 99)},
            **info, "forward_times": server.forward_times()}


def _attach(actor_mode: str, seconds: float) -> dict:
    """``serve --attach`` with 4 in-process clients, as ``chip_smoke.py``'s
    ``serve_attach`` runs it, actors as a thread or 2 worker processes."""
    from ape_x_dqn_tpu_torch import serve

    argv = ["--attach", "--clients", "4", "--duration", str(seconds),
            "--metrics-every", str(seconds), "--device", "cuda", "--steps", "10000000",
            "--set", "learner.device_replay=true", "--set", "learner.steps_per_call=128",
            "--set", "learner.ingest_block=256", "--set", "network=conv",
            "--set", "env.name=catch:84", "--set", "replay.capacity=100000",
            "--set", "learner.min_replay_mem_size=2048", "--set", "actor.num_actors=8",
            "--set", f"actor.mode={actor_mode}", "--set", "actor.num_workers=2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(argv)
    recs = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    final = [r for r in recs if "serve/served_total" in r][-1]
    trainer = [r for r in recs if "step" in r and "serve/served_total" not in r]
    return {"case": f"attach_{actor_mode}_actors", "qps": final["serve/served_total"] / seconds,
            "p50_ms": final.get("serve/p50_ms"), "p99_ms": final.get("serve/p99_ms"),
            "reloads": final["serve/reloads"], "batch_hist": final["serve/batch_hist"],
            "learner_steps": trainer[-1]["step"] if trainer else 0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ape_x_dqn_tpu_torch.profile_serving")
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")
    from ape_x_dqn_tpu_torch.runtime import graphed_call
    from ape_x_dqn_tpu_torch.serving.server import PolicyServer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.manual_seed(0)
    net, state, calls = _learners(dev, gen)
    params = {k: v.detach().clone() for k, v in state.params.items()}
    server = PolicyServer(net, params, max_batch=32, max_wait_ms=0.2)
    server.warmup(OBS)
    server.start()
    paced = graphed_call.MAX_REPLAYS_AHEAD

    def learner(key, ahead):
        call, ring = calls[key]

        def learn(seconds):
            graphed_call.MAX_REPLAYS_AHEAD = ahead
            t0 = time.monotonic()
            steps = 0
            while steps == 0 or time.monotonic() - t0 < seconds:
                call(state, ring, 0.4, generator=gen)
                steps += call.steps_per_call
            torch.cuda.synchronize()
            return steps / (time.monotonic() - t0)
        return learn

    try:
        for name, learn in (("idle", None),
                            ("dedup_paced", learner("dedup", paced)),
                            ("dedup_unpaced", learner("dedup", 0)),
                            ("double_strict", learner("double_strict", paced)),
                            ("double_sample_ahead", learner("double_sample_ahead", paced))):
            print(json.dumps(_case(name, server, learn, args.seconds)), flush=True)
    finally:
        graphed_call.MAX_REPLAYS_AHEAD = paced
        server.close()
    del calls, state, net
    torch.cuda.empty_cache()
    for mode in ("thread", "process"):
        print(json.dumps(_attach(mode, 4 * args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
