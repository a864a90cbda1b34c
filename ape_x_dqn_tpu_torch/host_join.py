"""Attach a host's workers to a running learner over tcp:
``python -m ape_x_dqn_tpu_torch.host_join --join SPEC``.

The port's copy of ``tools/host_join.py``.  The learner reserves remote
slots (``actor.remote_workers`` with ``actor.transport=tcp``) and its pool
writes a join spec to ``actor.remote_join_path``: one tcp endpoint per
remote worker id (the learner's address and port, the per-run token,
attempt 0, the wire knobs), the run's config and the width of the global
actor partition.  This launcher reads the spec and runs the pool's own
worker entry (``runtime/process_actors._worker_main``) once per claimed
slot, in spawned CPU-only children that dial the learner back:

    # the learner:
    python -m ape_x_dqn_tpu_torch.train --set actor.mode=process \\
        --set actor.transport=tcp --set actor.remote_workers=2 \\
        --set actor.remote_join_path=/shared/host_join.json ...
    # the worker host:
    python -m ape_x_dqn_tpu_torch.host_join --join /shared/host_join.json

Experience travels in CRC-framed records (a torn frame is counted, never
ingested); params arrive on the same connection, full then page-deltas; a
dropped connection reconnects with backoff.  The launcher owns its
children's incarnations: a child that dies is respawned on the SAME
attempt, which the learner's channel admits, and only after the dead
child has been reaped, so the channel never has two writers.  Its budget
is the spec's whole ``actor.T``: the learner counts steps from the chunks
it ingests.  Episode stats and errors print here as JSONL lines; they have
no path back to the learner.

``--host`` overrides the learner address the spec advertises (a learner
bound to loopback advertises 127.0.0.1, which only a same-host join can
dial).

This module and what it imports before a child starts are stdlib + numpy:
the children hide the card before they import torch.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import queue as queue_mod
import signal
import sys
import time

from ape_x_dqn_tpu_torch.runtime.process_actors import _worker_main


def _say(**fields) -> None:
    print(json.dumps(fields), flush=True)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ape_x_dqn_tpu_torch.host_join",
                                description="attach this host's workers to a learner")
    p.add_argument("--join", default="host_join.json",
                   help="the join spec the learner's pool wrote")
    p.add_argument("--workers", type=int, default=0,
                   help="slots to claim (0 = every slot from --offset on)")
    p.add_argument("--offset", type=int, default=0,
                   help="first slot of the spec to claim (hosts that split a spec)")
    p.add_argument("--host", default=None, help="override the learner's address")
    p.add_argument("--nice", type=int, default=None,
                   help="override actor.worker_nice on this host")
    p.add_argument("--wait-s", type=float, default=60.0,
                   help="how long to wait for the join spec to appear")
    p.add_argument("--no-respawn", action="store_true", help="do not respawn dead children")
    p.add_argument("--duration", type=float, default=0.0,
                   help="stop after this many seconds (0 = until a signal or every "
                   "child has finished)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    deadline = time.monotonic() + args.wait_s
    while not os.path.exists(args.join):
        if time.monotonic() > deadline:
            _say(event="host_join_error", error=f"no join spec at {args.join}")
            return 1
        time.sleep(0.25)
    with open(args.join) as f:
        doc = json.load(f)
    specs = doc["specs"][args.offset:]
    if args.workers:
        specs = specs[:args.workers]
    if not specs:
        _say(event="host_join_error", error="no remote slots to claim")
        return 1
    if args.host:
        for spec in specs:
            spec["host"] = args.host

    ctx = mp.get_context("spawn")
    stop_evt = ctx.Event()
    queues: dict = {}
    procs: dict = {}
    nice = args.nice if args.nice is not None else int(doc["cfg"]["actor"]["worker_nice"])

    def spawn(spec) -> None:
        wid = int(spec["wid"])
        queues.setdefault(wid, ctx.Queue(maxsize=64))
        p = ctx.Process(
            target=_worker_main,
            args=(wid, doc["cfg"], int(doc["num_workers_total"]), {"kind": "net"}, spec,
                  queues[wid], stop_evt, int(doc["budget"]), int(doc["quantum"]),
                  int(spec["attempt"]), nice),
            daemon=True,
        )
        p.start()
        procs[wid] = p
        _say(event="host_join_spawn", wid=wid, pid=p.pid,
             learner=f"{spec['host']}:{spec['port']}")

    for spec in specs:
        spawn(spec)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop_evt.set())
    _say(event="host_join_up", workers=len(procs), wids=sorted(procs))

    done: set = set()
    counts = {"respawns": 0, "episodes": 0}

    def drain() -> None:
        for wid, q in queues.items():
            try:
                while True:
                    msg = q.get_nowait()
                    if msg[0] == "done":
                        done.add(wid)
                        _say(event="host_join_done", wid=wid, steps=msg[2])
                    elif msg[0] == "error":
                        _say(event="host_join_worker_error", wid=wid, error=msg[2])
                    elif msg[0] == "episodes":
                        counts["episodes"] += len(msg[2])
            except queue_mod.Empty:
                pass
            except Exception:  # noqa: BLE001 — a torn pickle from a child killed mid-put
                pass

    t_end = time.monotonic() + args.duration if args.duration else None
    try:
        while not stop_evt.is_set():
            if t_end is not None and time.monotonic() > t_end:
                break
            drain()
            for spec in specs:
                wid = int(spec["wid"])
                p = procs[wid]
                if not p.is_alive():
                    drain()   # a child's last messages are in the pipe once it exited
                if not p.is_alive() and wid not in done and not args.no_respawn:
                    # Same attempt on purpose: the learner's channel admits
                    # only it.  The dead writer is reaped first, so the
                    # channel never has two.
                    p.join(timeout=5.0)
                    counts["respawns"] += 1
                    _say(event="host_join_respawn", wid=wid, exitcode=p.exitcode)
                    spawn(spec)
            if len(done) == len(procs) or (args.no_respawn and not any(
                    p.is_alive() for p in procs.values())):
                break
            time.sleep(0.25)
    finally:
        stop_evt.set()
        deadline = time.monotonic() + 15.0
        for p in procs.values():
            # Drain while joining: a child blocked on a full control queue
            # exits only once it is read.
            while p.is_alive() and time.monotonic() < deadline:
                drain()
                p.join(timeout=0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        drain()
        for q in queues.values():
            q.close()
    _say(event="host_join_exit", finished=sorted(done), **counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
