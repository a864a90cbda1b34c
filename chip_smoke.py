#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   — the card's name and count, and nvidia-smi's name and
                power limit;
  2. build    — compile the sampling kernel (``ops/csrc/sampling.cu``) from
                the checkout with nvcc, and the host replays' C++ cores
                (``_native/sum_tree.cc``, ``_native/replay_core.cc``) with
                g++, timed;
  3. kernel   — hold the kernel against its plain PyTorch version at
                C = 100 000 and 2 000 000, B = 32 and 4096, and at the dedup
                path's C = 2 000 000, B = 65 536 (plain, and with 20 % of
                the slots zeroed at random positions): identical
                indices on integer-valued priorities (exact in float32),
                every index inside its inverse-CDF bracket (float64, within
                1e-5·total) on real-valued ones, zero-mass blocks and a C
                that is not a multiple of 4; identical indices from two
                calls on the same real-valued priorities (determinism);
                exactly one device kernel and no memset per call (profiler);
                a call captured in a CUDA graph, replayed after the
                priorities changed in place.  Device times of the kernel and
                the plain version (``bench_sampler``: warm = CUDA-graph
                replay, cold = profiler spans after an L2 flush) and the
                host time of one wrapper call;
  3a. atari_golden — the port's numpy ``ObsPreprocess`` (cv2's fixed-point
                luminance and area resize, no cv2) against
                ``tests/fixtures/atari_golden.npz``, byte for byte; host µs
                per agent step of ``make_env("fake-atari")`` and per
                preprocess;
  4. parity   — one small fused learner run twice, on the card and on the
                CPU, with the same weights, chunks and uniforms (float32
                compute, TF32 off): the parameter updates must agree;
  5. train    — the main path through the user's entry point,
                ``ape_x_dqn_tpu_torch.train.main``, at the full width of the
                conv dueling network (64/64/64, hidden 512) on 84×84×1
                frames, device replay of 100 000 slots, B = 32, K = 128,
                8 actors: the loss must be finite, the steps reached, and
                every sample drawn by the kernel (launch count == steps);
  6. host_parity — the host replay path's placement and step: a port
                ``PrioritizedReplay`` filled from a seed, batches sampled
                and placed on the card through the prefetch queue's
                ``DevicePlacer`` (pinned staging, copy stream, event), each
                batch on the card equal to its host batch byte for byte;
                then one full-width train step on the card and one on the
                CPU from the same batch and params (float32, TF32 off): the
                parameter updates must agree within 1e-3 of the largest;
  7. host_train — the default host-replay path through ``train.main``
                (async mode) at the width of phase 5, 100 000 host slots,
                512 learner steps: finite loss, steps reached, train state
                on the card, ``stage_us``, rates, peak device memory, the
                replay's frame bytes, and the sampler kernel's launches on
                this path (0: the host path samples on the CPU's sum-tree);
  8. host_sync — ``train.main --mode sync`` for 64 learner steps on the
                card, finite loss;
  9. proc_train — phase 5 with ``--set actor.mode=process --set
                actor.num_workers=2``: the 8 actors run in two CPU-only
                worker processes.  The run goes past 512 steps until both
                workers have delivered a chunk acted with a published param
                version (> 1), within 60 s.  Finite loss, steps reached,
                sampler launches == steps, chunks from both workers past
                param version 1, 0 restarts, both workers reporting no CUDA
                initialisation, at most one pid (the learner's) in
                nvidia-smi's compute apps while it runs, and no /dev/shm
                segment of the run left after it; prints rates, peak device
                memory, transport counts and each worker's threads and
                env steps/s;
 10. proc_host_train — the same on the host-replay path (phase 7's), with
                ``stage_us``, the replay's frame bytes and 0 sampler
                launches;
 10a. host_dedup_parity — the host frame-dedup replay on this machine's
                host: the numpy ``DedupReplay`` and the C++
                ``NativeDedupReplay`` (n_stripes 1) over one seeded stream of
                84×84 chunks (C = 4 096, frame ratio 0.75: wraps, frame
                death, a carry gap): identical slots, indices and frame
                bytes, IS weights within rtol 2e-7; a tiered twin of each
                (a fifth of the ring hot) byte-identical to its dense twin
                with spills and fault reads > 0 (``tools/spill_smoke.py``
                gate 1 on the port); 0 sampler launches;
 10b. host_dedup_train — this slice's main path: config3's learner on host
                replay: ``proc_host_train``'s run with the host
                ``DedupReplay`` at 2 000 000 slots (frame ratio 1.25, a
                lazily touched 17.64 GB ring), bf16 ν and target.  Checks:
                the steps, the train state on the card, 0 sampler launches,
                0 frame-dead slots, the workers' checks.  Learner steps/s,
                actor fps, frames and frame bytes per transition beside
                ``proc_host_train``'s; RSS and ``MemAvailable`` before and
                after;
 10c. tier_train — phase 10b with ``replay.hot_frame_budget_bytes`` 32 MiB
                under an 8 192-row warm-up, the exporter on and incremental
                checkpoints: hot bytes within the budget (plus the prefetch
                queue's samples' and one chunk's spans) at every JSONL
                record, spills and faults > 0, ``/healthz`` 200 at every
                scrape with the ``tier_evictor`` heartbeat; then a fresh
                ``train.main`` restores the chain (cold spans adopted by
                ref): size, total_added and a fixed-generator sample equal
                to the saved replay's, and 64 more steps.  Base bytes
                against a dense base, restore s, fault ms;
 10d. host_dedup_2m — host only: ``bench.py``'s ``host_dedup_2m`` on the
                port's ``NativeDedupReplay`` at 2 000 000 slots half full,
                n_stripes 1 and 4 (pairs/s, adds/s, frame GB), and its
                ``replay_tiered`` point at 200 000 slots (in core against
                tiered, spills and faults); ``MemAvailable`` and free disk
                first;
 11. dedup_parity — the frame-dedup ring (C = 4 096, Cf = 5 120, catch:84
                frames from a seeded fleet, > 3 frame-ring wraps) on the card
                against the same ring on the CPU: mass, refs and counters
                identical after every ingest; on integer priorities the
                sampled indices identical and the gathered frames byte-equal;
                one full-width fused dedup call within phase 4's tolerance;
                2 sampler launches;
 12. graph_parity — the fused call as CUDA-graph replays against the same
                body run eagerly on the card, from one state and the same
                uniforms, at full width on rings of C = 4 096: both layouts,
                strict and sample-ahead, float32, TF32 off, cuDNN's
                deterministic algorithms (the default ones may sum a
                convolution's gradient in another order on every call, and
                a strict call then samples other slots from its second
                step on: a different trajectory, not a graph's error).  Sample-ahead
                indices identical in every step, strict step 0 identical
                (later strict steps: mismatches reported), losses, updates
                and masses within 1e-3 of the largest; a rebound parameter
                tensor recaptures and the replays go on equal; one profiled
                graphed call holds in its trace exactly the sampler kernels
                the runner counted;
 13. dedup_train — ``train.main`` with config3's learner on one card: the
                dedup ring at 2 000 000 slots (frame_ratio 1.25), sample-ahead
                K = 2048, ingest blocks of 2048, bf16 second moment and
                target, target sync 2500 (→ 2048), publish 2500, process
                actors (cuts listed in its output).  Sampler launches ==
                fused calls (2), peak device memory below the double-store's
                frame bytes, learner steps/s over the second call, ring
                bytes, dropped carries, frame/transition ratio, dead slots,
                workers without CUDA, /dev/shm clean;
 13a. obs_train — phase 13's learner (right after it, in the same process)
                with ``obs.export_port=0``, the supervisor and post-mortems
                on, driven while it trains: after 4 fused calls ``/metrics``,
                ``/varz`` and ``/healthz`` scraped (200, every component
                fresh) and ``tools/obs_top.py --varz URL --once`` run (exit 0,
                a frame with both workers); then twice ``/varz?trace=1`` at
                the default window (512 steps, started and stopped between
                graph replays inside the 2048-step calls; the first armed
                between two calls) until the capture is ``done``: exactly
                512 steps traced, device kernels in the trace, its graph
                replays equal to the runner's count over the window, its
                sampler kernels all launched in the window and equal to the
                wrapper's count (the first capture's 1), ``/healthz``
                scraped every half second and 200 at every scrape from the
                trigger to the end of the call after ``done``, the top
                device ops, the idle share, the capture's cost and records
                and the device record that leads its launch most printed;
                then worker 1 SIGKILLed: its
                post-mortem file holds the salvaged block's events, it is
                respawned and fed again, and ``supervisor/respawns`` reads
                1 on ``/varz``.  One sampler launch per fused call; learner
                steps/s over the calls outside the captures and the
                respawn, and the second call alone, beside phase 13's; no
                /dev/shm segment left;
 13b. obs_train_host — the host-replay path with 2 worker processes, 512
                steps at phase 7's width, every chunk traced: every lineage
                span monotone (act, ingest, first sample, trained at the
                deferred write-back), spans from both workers, the
                age-at-sample histogram at steps × 32 rows, 0 sampler
                launches, no /dev/shm segment left;
 14. overlap_train — phase 13 with ``learner.pipeline_depth=2`` and
                ``learner.sync_every=2048``: the overlapped pipeline
                (stager thread, ``DispatchPipeline``).  Its ``pipeline``
                section (inflight 0, host syncs within steps/sync_every +
                calls/depth + 2), the staged rows left beside phase 13's,
                learner steps/s;
 14a. atari_train — this slice's main path: phase 14's learner fed by 2
                workers × 8 actors on the full DQN stack over fake-atari
                (frame skip 4, episodic life, reward clip; 84×84×1), under
                the seeded chaos schedule (``ATARI_CHAOS``: kills, torn
                kills, SIGSTOPs, stager stalls, /dev/shm fills, ``SlowEnv``
                in the workers), the supervisor and the exporter on; a
                ``ChaosController`` forces a kill (timed to fed again), tops
                up the kinds the schedule has not reached and stalls the
                stager once, sampling the ingest lag.  Checks: every kind
                executed, none failed; every torn record detected, none
                delivered; respawns ≥ kills, 0 quarantines; the step
                increasing across calls; ``chaos/<kind>`` on ``/metrics``
                equal to the monkey's counts; ``/healthz`` answering at
                every scrape, 503 only for ``ingest_stager`` in a stall;
                one sampler launch per call; no /dev/shm segment left.
                Learner steps/s per call and actor fps beside phase 14's;
 15. serve_parity — the card's ``PolicyServer`` (its forwards on a
                high-priority stream of their own) against the port's plain
                CPU forward at full width, float32, TF32 off, for every batch
                size 1..32: q within 1e-4 of the largest |q|, actions equal
                wherever the top-2 gap exceeds 2e-4 of it; a hot reload under
                load (4 clients, 3 published versions): no request dropped,
                every reply's q its claimed version's; each bucket's host and
                device ms per eager batch at bf16, beside the same forward's
                device ms as a CUDA-graph replay;
 15a. serve_delay — the card's ``PolicyServer`` with the chaos serving delay
                (5 ms, ±25 % seeded) beside the same server without it and
                a CPU server with it, one client: the card's delay stream
                equal to the CPU server's, p50 at least 3.75 ms higher;
 16. central_train — phase 13 with ``actor.inference=central``: the 2
                workers × 8 actors are paramless and act through the
                ``PolicyServer`` that the runtime hosts on the card behind a
                ``ServingNetServer``.  Learner steps/s and each worker's env
                steps/s beside phase 13's (local), the round trip's p50/p99
                while the learner replays, batch occupancy, version lag, the
                server's per-bucket times; checks: no param buffer, no params
                and no CUDA in any worker, every fleet step's actions from
                the server, 0 torn frames and replies, 2 sampler launches;
 16a. central_fleet — the replica fleet's path: phase 16's learner (4 fused
                calls) with the 2 × 8 paramless workers dialing the router of
                a 2-replica ``serving/router.ServingFleet`` on the card
                (``serve --param-hub`` children with the run's token), the
                learner's publishes relayed to the fleet's hub, replica 0
                SIGKILLed after the first call.  Checks: the step target, one
                sampler launch per call, 0 worker deaths, 0 torn replies and
                frames, no fallback, replies at relayed versions ≥ 3, the
                respawn back in rotation at the newest version, both
                replicas' pids on the card.  Learner steps/s beside phase
                16's, the round trips while learning, the relay's pushes;
 17. central_wide — phase 16 with 2 workers × 32 actors, then the same
                fleet local (``central_wide_local``), in one call;
 18. serve_attach — ``serve.main(["--attach", "--listen", "0", "--clients",
                "4", ...])``: phase 5's device-replay learner trains in a
                thread while 4 closed-loop clients act through the server
                and it hot-reloads the learner's publishes: QPS, latency
                p50/p99, reloads, 0 client errors;
 19. ckpt_parity — resume in a fresh process equals the uninterrupted
                learner: full-width fused learners (float32, TF32 off,
                cuDNN's deterministic algorithms, sample-ahead K = 64,
                B = 32) on the double-store ring at 4 096 and 100 000 slots
                and the dedup ring at 4 096 run two calls and save (the npz
                leg; for the dedup ring an APXC base and one delta, written
                off the learner thread), a chunk still staged; call 3 is the
                reference.  A spawned ``chip_smoke.py --ckpt-child`` builds
                fresh learners, restores them in place and runs call 3:
                sampled indices, params, ν, target, masses and counters
                bit-identical, no recapture after the restore, one sampler
                launch per resumed call;
 20. ckpt_train — ``train.main`` with config3's learner on a ring cut to
                262 144 slots, 8 thread actors, incremental checkpoints
                every 2048 steps, as a child process SIGKILLed after its
                second committed manifest; then ``train.main`` with
                ``learner.restore_from=true`` and the overlapped pipeline:
                it resumes at the committed step with the ring's counts at
                the chain's mark, trains one more call (one sampler launch)
                and its save continues the chain; no /dev/shm segment left.
                The stall of each save, the bytes of each chunk, the
                restore's seconds;
 21. serve_checkpoint — ``serve.main(["--checkpoint", ckpt_train's dir,
                "--listen", "0", "--clients", "4", ...])``: a newer step
                committed mid-run is reloaded and served (its version in
                the replies, a probe's q within 1e-4 of the CPU forward of
                its params, the served network in float32), 0 client
                errors; QPS and latency p50/p99;
 21a. serve_fleet — ``python -m ape_x_dqn_tpu_torch.serve --replicas 2
                --checkpoint`` over phase 21's directory as a child, 4
                closed-loop clients through its router: each replica's q
                against a CPU forward of the checkpoint's params at the
                replicas' bf16 compute (within 2e-2 of the largest |q|), a
                step committed mid-burst reaching both replicas as a page
                delta with ``param_version`` 2, replica 0 SIGKILLed (drained
                within one 0.25 s probe, 0 dropped requests, 0 torn frames,
                respawned, full-synced, routed to again), both replicas'
                pids on the card and not the router's, rc 0 after SIGTERM;
                QPS, round trip p50/p99, push bytes, drain and respawn s;
 21b. chaos_restore — config3's learner at phase 20's 262 144 slots on
                fake-atari with 8 thread actors, a save every K steps and a
                new base after each delta: calls until the chain's second
                generation is committed and a clean stop, then the chaos
                monkey's ``corrupt_chunk`` on the live generation, then
                ``restore_from=true`` through the damaged chain: a
                ``degraded_restore`` event, ``fallback_restores`` ≥ 1, the
                resume at the newest committed step, one more call, one
                sampler launch per call;
 22. tcp_train — phase 13 with ``actor.transport=tcp`` (run right after it,
                in the same process): the 2 workers feed the learner over
                loopback sockets, 256 KiB coalesced frames with in-window
                frame dedup, the params back as delta-or-full frames.
                Learner steps/s (and the second call alone) and actor fps
                beside phase 13's, wire bytes/s and per transition, wire
                over logical bytes, param pushes full and delta and the
                64 KiB pages the last publish changed, ``version_lag``,
                peak device memory; checks: 0 torn frames, every record
                ingested, no /dev/shm segment, params from the wire, no
                CUDA in a worker, 2 sampler launches;
 23. remote_join — phase 22's learner with 1 local worker,
                ``actor.remote_workers=1`` and ``actor.max_workers=2``: a
                ``python -m ape_x_dqn_tpu_torch.host_join`` process claims
                the remote slot from the join spec; its child is SIGKILLed
                and must be respawned (same attempt) and feed again; then
                ``pool.grow(1)`` and ``pool.retire()``; the run stops once
                that is done and 2 calls have run.  One sampler launch per
                call, a reconnect counted, the grown worker's chunks
                ingested, its retirement clean, host_join exits 0, no
                /dev/shm segment left; the times of each step;
 24. serve_hub — a ``NetTransport`` here is the param hub: phase 22's
                trained params (version 1) and a one-bias change (version
                2, a page delta); a ``serve --param-hub --clients 4``
                process (``chip_smoke.py --serve-child``, float32) serves
                each version with q within 1e-4 of a float32 forward; a
                ``serve`` here with ``serving.param_stale_s=2`` sheds with
                ``E_OVERLOADED`` once publishing pauses and recovers on
                version 3; ``serve --param-tail`` over a
                ``ParamTailWriter`` chain (a full, a delta) serves the same
                versions with the same q;
 25. kernels  — one JSON object per ported kernel with its launches on
                atari_train (the sampler's main path) and on each path (the
                host paths' 0 each), error, times and bound at that path's
                shape (C = 2M, T = 65 536), after a line with the whole
                smoke's seconds.
Every device-replay phase (4, 5, 9, 11–14, 14a, 16–23, 16a, 21b) runs each fused call as
CUDA-graph replays, the port's only device path.  Every process phase
checks that no /dev/shm segment of the run (rings, param buffers, worker
stats blocks) is left.  Checkpoints go under the checkout's
``build/ckpt_smoke/``, obs_train's post-mortems and traces under
``build/obs_smoke/``, the join spec under
``build/remote_join_smoke/``, the param tail under
``build/param_tail_smoke/``, serve_fleet's stderr under
``build/fleet_smoke/``, the spill files and tier_train's chain under
``build/spill_smoke/``; all are removed at the end.
The line before the last is nvidia-smi's "name, power limit"; the last is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA device, the kernel does not build, or any check fails.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 0
# config3's learner as the dedup phases run it: fused call length, ring
# slots, warm-up rows (cut from 50 000).
DEDUP_K = 2048
DEDUP_SLOTS = 2_000_000
# Warm-up rows of the dedup phases (config3: 50 000), cut to 4 096 to make
# room in the smoke's time; atari_train, this smoke's longest-standing main
# path, keeps 16 384.
DEDUP_WARMUP = 4_096
ATARI_WARMUP = 16_384


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check_brackets(p, t, idx) -> float:
    """Every idx must satisfy cdf[i-1] <= t < cdf[i] in float64, within
    1e-5·total.  Returns the worst violation as a fraction of the total."""
    p64 = p.double().cpu().numpy()
    cdf = np.cumsum(p64)
    total = cdf[-1]
    i = idx.long().cpu().numpy()
    tt = t.double().cpu().numpy()
    lo = np.where(i > 0, cdf[np.maximum(i - 1, 0)], 0.0)
    hi = cdf[i]
    worst = max(float(np.max(lo - tt, initial=0.0)),
                float(np.max(tt - hi, initial=0.0))) / total
    if worst > 1e-5:
        raise AssertionError(f"kernel index outside its inverse-CDF bracket by "
                             f"{worst:.3g}·total")
    return worst


def phase_kernel(sampling):
    import torch

    from ape_x_dqn_tpu_torch import bench_sampler as bench

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(bench.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = []
    # (C, B, share of slots zeroed at random positions): the earlier slices'
    # shapes, then the dedup path's sample-ahead launch (K = 2048 × B = 32
    # targets over a 2M ring), plain and with scattered dead slots as the
    # liveness sweep leaves them.
    cases = [(100_000, 32, 0.0), (100_000, 4096, 0.0), (2_000_000, 32, 0.0),
             (2_000_000, 4096, 0.0), (2_000_000, 65_536, 0.0), (2_000_000, 65_536, 0.2)]
    for C, B, dead in cases:
        # Integer priorities whose total stays below 2^24: every prefix sum
        # is exact in float32, in any order, so indices must be identical.
        hi = max(2, 2**24 // C)
        zero = rng.random(C) < dead if dead else np.zeros(C, bool)
        p_int = torch.as_tensor(np.where(zero, 0, rng.integers(0, hi, C)).astype(np.float32),
                                device=dev)
        p_real = torch.as_tensor(np.where(zero, 0, rng.random(C, dtype=np.float32))
                                 .astype(np.float32), device=dev)
        t_int = bench.stratified_targets(p_int, B, rng)
        k = sampling.sample_indices(p_int, t_int)
        ref = sampling.sample_indices_reference(p_int, t_int)
        torch.cuda.synchronize()
        if not torch.equal(k, ref):
            bad = int((k != ref).sum())
            raise AssertionError(f"C={C} B={B}: {bad} indices differ on "
                                 "integer priorities")
        t_real = bench.stratified_targets(p_real, B, rng)
        k_real = sampling.sample_indices(p_real, t_real)
        ref_real = sampling.sample_indices_reference(p_real, t_real)
        worst = check_brackets(p_real, t_real, k_real)
        if not torch.equal(k_real, sampling.sample_indices(p_real, t_real)):
            raise AssertionError(f"C={C} B={B}: two calls on the same "
                                 "priorities gave different indices")
        calls = bench.device_calls(
            lambda: sampling.sample_indices(p_real, t_real), 3, flush)
        if any(len(c) != 1 for c in calls):
            raise AssertionError(f"C={C} B={B}: device activities per call "
                                 f"{[[a[0] for a in c] for c in calls]}, "
                                 "want one kernel")

        def kernel():
            return sampling.sample_indices(p_real, t_real)

        def plain():
            return sampling.sample_indices_reference(p_real, t_real)

        timed = bench.measure(kernel, C, B, 50, flush)
        plain_t = bench.measure(plain, C, B, 50, flush)
        rows.append({
            "C": C, "B": B, "dead_share": float(zero.mean()),
            "grid": list(sampling.plan(C, num_sms)),
            "ms": timed["cold_ms"], **timed,
            "plain_ms": plain_t["cold_ms"], "plain_warm_ms": plain_t["warm_ms"],
            "plain_host_us": plain_t["host_us"],
            "bound_ms": bench.bound_ms(C, B),
            "max_abs_err": int((k - ref).abs().max()),
            "bracket_violation_of_total": worst,
            "real_idx_max_abs_diff_vs_plain":
                int((k_real.long() - ref_real.long()).abs().max()),
            "kernel_activity": calls[0][0][0],
        })
        emit({"phase": "kernel", **rows[-1]})
    # Zero-mass blocks, a C that is not a multiple of 4, targets at and
    # past the total.
    C = 100_003
    p = np.zeros(C, np.float32)
    live = rng.choice(C, 64, replace=False)
    p[live] = rng.integers(1, 50, 64)
    p[C - 1] = 3.0
    p = torch.as_tensor(p, device=dev)
    total = float(p.sum())
    t = torch.as_tensor(np.concatenate([
        np.sort(rng.random(253)) * total, [0.0, total, 1.5 * total]
    ]).astype(np.float32), device=dev)
    k = sampling.sample_indices(p, t)
    ref = sampling.sample_indices_reference(p, t)
    if not torch.equal(k, ref):
        raise AssertionError("zero-mass / ragged case differs from the plain version")
    if int(k[-1]) != C - 1:
        raise AssertionError("a target past the total must resolve to the last leaf")
    emit({"phase": "kernel", "case": "zero-mass blocks, C=100003", "identical": True})
    # A call captured in a CUDA graph, replayed after p changed in place.
    C, B = 2_000_000, 4096
    p = torch.as_tensor(rng.integers(0, 8, C).astype(np.float32), device=dev)
    t = bench.stratified_targets(p, B, rng)
    sampling.sample_indices(p, t)  # set-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = sampling.sample_indices(p, t)
    p.copy_(torch.as_tensor(rng.integers(0, 8, C).astype(np.float32), device=dev))
    t.copy_(bench.stratified_targets(p, B, rng))
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(captured, sampling.sample_indices_reference(p, t)):
        raise AssertionError("graph replay after an in-place change of p differs "
                             "from the plain version")
    emit({"phase": "kernel", "case": "CUDA graph replay, p changed in place",
          "identical": True})
    return rows


def phase_parity():
    """The same small fused learner on the card and on the CPU."""
    import torch

    from ape_x_dqn_tpu_torch.learner.train_step import init_train_state, make_optimizer
    from ape_x_dqn_tpu_torch.models.dueling import build_network
    from ape_x_dqn_tpu_torch.runtime.fused_learner import FusedDeviceLearner
    from ape_x_dqn_tpu_torch.types import NStepTransition

    rng = np.random.default_rng(SEED)
    obs_shape, A, M, K, B = (36, 36, 1), 3, 512, 4, 8
    chunk = NStepTransition(
        obs=rng.integers(0, 256, (M, *obs_shape), dtype=np.uint8),
        action=rng.integers(0, A, M).astype(np.int32),
        reward=rng.normal(size=M).astype(np.float32),
        discount=np.full(M, 0.97, np.float32),
        next_obs=rng.integers(0, 256, (M, *obs_shape), dtype=np.uint8),
    )
    prio = (rng.random(M) + 0.1).astype(np.float32)
    u = rng.random((2, K, B), dtype=np.float32)
    torch.manual_seed(SEED)
    net = build_network("conv", A, obs_shape, channels=(8, 8, 8), hidden=32,
                        compute_dtype=torch.float32)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", "cuda"):
            opt = make_optimizer("rmsprop")
            state = init_train_state(net, opt, seed=SEED, device=dev)
            learner = FusedDeviceLearner(net, opt, state, obs_shape, capacity=1000,
                                         batch_size=B, steps_per_call=K,
                                         ingest_block=128, target_sync_freq=K,
                                         device=dev)
            learner.add_chunk(prio, chunk)
            learner.ingest_staged(drain=True)
            for call in range(2):
                learner.train(0.4, u=torch.as_tensor(u[call]))
            out[dev] = ({k: v.cpu() for k, v in learner.state.params.items()},
                        learner.replay.mass.cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    init = {k: v.cpu() for k, v in net.state_dict().items()}
    worst = 0.0
    for k in init:
        d_cpu = out["cpu"][0][k] - init[k]
        d_gpu = out["cuda"][0][k] - init[k]
        scale = float(d_cpu.abs().max()) + 1e-12
        worst = max(worst, float((d_cpu - d_gpu).abs().max()) / scale)
    mass_err = float((out["cpu"][1] - out["cuda"][1]).abs().max())
    # Conv and matmul sums run in other orders on the card; RMSProp's
    # normalised update keeps the relative error of each update near the
    # gradients' (~1e-6); 1e-3 of the largest update leaves room for that.
    if worst > 1e-3 or mass_err > 1e-4:
        raise AssertionError(f"card vs CPU fused learner: update error {worst:.3g} "
                             f"of the largest update, mass error {mass_err:.3g}")
    emit({"phase": "parity", "param_update_err_rel": worst, "mass_max_abs_err": mass_err,
          "tolerance": {"param_update_err_rel": 1e-3, "mass_max_abs_err": 1e-4}})


def phase_train(sampling, card: str, steps: int = 512):
    import torch

    from ape_x_dqn_tpu_torch import train

    argv = [
        "--device", "cuda", "--steps", str(steps), "--log-every", "128",
        "--set", "learner.device_replay=true",
        "--set", "network=conv",
        "--set", "env.name=catch:84",
        "--set", "replay.capacity=100000",
        "--set", "learner.replay_sample_size=32",
        "--set", "learner.steps_per_call=128",
        "--set", "learner.ingest_block=256",
        "--set", "learner.min_replay_mem_size=2048",
        "--set", "actor.num_actors=8",
        "--set", f"seed={SEED}",
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sampling.sample_indices.launches = 0
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv)
    wall = time.monotonic() - t0
    launches = sampling.sample_indices.launches
    records = [json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{")]
    final = records[-1]
    if rc != 0 or not final.get("final"):
        raise AssertionError(f"train.main returned {rc} without a final record")
    if final["step"] < steps:
        raise AssertionError(f"reached {final['step']} of {steps} learner steps")
    loss = final.get("learner/loss")
    if loss is None or not np.isfinite(loss):
        raise AssertionError(f"loss not finite: {loss}")
    if launches != final["step"]:
        raise AssertionError(f"{launches} sampler kernel launches for "
                             f"{final['step']} strict learner steps")
    result = {
        "phase": "train", "card": card, "learner_steps": final["step"], "loss": loss,
        "sampler_launches": launches,
        "learner_steps_per_s": final["step"] / final["train_s"],
        "train_s": final["train_s"], "wall_s": wall,
        "actor_steps": final["actor_steps"], "replay_size": final["replay_size"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    emit(result)
    return result


FULL_WIDTH = [
    "--set", "network=conv",
    "--set", "env.name=catch:84",
    "--set", "replay.capacity=100000",
    "--set", "learner.replay_sample_size=32",
    "--set", "learner.min_replay_mem_size=2048",
    "--set", "actor.num_actors=8",
    "--set", f"seed={SEED}",
]


def phase_host_parity():
    """Host replay → prefetch placement on the card, byte for byte; then one
    full-width step on the card against the CPU from the same batch."""
    import torch

    from ape_x_dqn_tpu_torch.learner.train_step import (
        build_train_step,
        init_train_state,
        make_optimizer,
    )
    from ape_x_dqn_tpu_torch.models.dueling import build_network
    from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay
    from ape_x_dqn_tpu_torch.runtime.infeed import (
        DevicePlacer,
        PrefetchQueue,
        batch_to_device,
    )
    from ape_x_dqn_tpu_torch.types import NStepTransition

    rng = np.random.default_rng(SEED)
    obs_shape, A, B, M = (84, 84, 1), 3, 32, 1024
    replay = PrioritizedReplay(100_000, obs_shape)
    for _ in range(8):
        replay.add((rng.random(M) + 0.05).astype(np.float32), NStepTransition(
            obs=rng.integers(0, 256, (M, *obs_shape), dtype=np.uint8),
            action=rng.integers(0, A, M).astype(np.int32),
            reward=rng.normal(size=M).astype(np.float32),
            discount=np.full(M, 0.97, np.float32),
            next_obs=rng.integers(0, 256, (M, *obs_shape), dtype=np.uint8),
        ))
    sample_rng = np.random.default_rng(SEED + 7)
    host = []

    def sample():
        batch = replay.sample(B, beta=0.4, rng=sample_rng)
        host.append(batch)
        return batch

    def fields(batch):
        t = batch.transition
        return [t.obs, t.action, t.reward, t.discount, t.next_obs,
                batch.indices, batch.is_weights]

    n_batches = 64
    scratch = torch.empty(1 << 26, device="cuda")
    with PrefetchQueue(sample, place_fn=DevicePlacer("cuda"), depth=2) as queue:
        for i in range(n_batches):
            placed = queue.get()
            dev = placed.wait()
            scratch.mul_(0.5)  # learner-stream work while the next copies run
            for d, h in zip(fields(dev), fields(host[i])):
                got = d.cpu().numpy()
                if got.dtype != h.dtype or got.tobytes() != np.ascontiguousarray(h).tobytes():
                    raise AssertionError(f"batch {i}: a field on the card differs "
                                         "from the host batch")
            if not np.array_equal(placed.indices, host[i].indices):
                raise AssertionError(f"batch {i}: host indices differ")
    del scratch
    torch.manual_seed(SEED)
    net = build_network("conv", A, obs_shape, compute_dtype=torch.float32)
    opt = make_optimizer("rmsprop")
    step = build_train_step(net, opt, loss_kind="huber", target_sync_freq=2500)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for dev_name, batch in (("cpu", batch_to_device(host[n_batches - 1], "cpu")),
                                ("cuda", dev)):
            state = init_train_state(net, opt, seed=SEED, device=dev_name)
            state, m = step(state, batch)
            out[dev_name] = ({k: v.cpu() for k, v in state.params.items()},
                             m.priorities.cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    init = {k: v.cpu() for k, v in net.state_dict().items()}
    worst = 0.0
    for k in init:
        d_cpu = out["cpu"][0][k] - init[k]
        d_gpu = out["cuda"][0][k] - init[k]
        worst = max(worst, float((d_cpu - d_gpu).abs().max())
                    / (float(d_cpu.abs().max()) + 1e-12))
    p_cpu, p_gpu = out["cpu"][1], out["cuda"][1]
    prio_err = float((p_cpu - p_gpu).abs().max()) / float(p_cpu.abs().max())
    # The same tolerance as phase_parity, for the same reason (conv and
    # matmul sums in other orders; RMSProp's normalised update).
    if worst > 1e-3 or prio_err > 1e-3:
        raise AssertionError(f"card vs CPU host step: update error {worst:.3g} of "
                             f"the largest update, priority error {prio_err:.3g}")
    emit({"phase": "host_parity", "batches_byte_equal": n_batches,
          "param_update_err_rel": worst, "priority_err_rel": prio_err,
          "tolerance": {"param_update_err_rel": 1e-3, "priority_err_rel": 1e-3}})


@contextlib.contextmanager
def capture_pipelines():
    """Observe the ``AsyncPipeline`` that ``train.main`` builds, so the phase
    can read its train state and replay after the run."""
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline

    seen, run = [], AsyncPipeline.run

    def observed(self, *args, **kwargs):
        seen.append(self)
        return run(self, *args, **kwargs)

    AsyncPipeline.run = observed
    try:
        yield seen
    finally:
        AsyncPipeline.run = run


def run_train(argv, records: list | None = None):
    """``train.main(argv)`` with its stdout captured: (final record, wall s).
    ``records``, when given, receives every JSONL record of the run."""
    from ape_x_dqn_tpu_torch import train

    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv)
    wall = time.monotonic() - t0
    records = records if records is not None else []
    records += [json.loads(line) for line in out.getvalue().splitlines()
                if line.startswith("{")]
    final = records[-1] if records else {}
    if rc != 0 or not final.get("final"):
        raise AssertionError(f"train.main returned {rc} without a final record")
    loss = final.get("learner/loss")
    if loss is None or not np.isfinite(loss):
        raise AssertionError(f"loss not finite: {loss}")
    return final, wall


# Smoke-time cuts that pay for replay_svc_train (each listed in its phase's
# output): host_train's, host_dedup_train's, tier_train's and
# obs_train_host's steps, obs_train's calls after the respawn, and the serve
# durations of serve_hub, serve_attach and serve_checkpoint.
HOST_TRAIN_STEPS = 256         # was 512
OBS_CALLS_AFTER = 1            # was 3
SERVE_HUB_DURATION_S = 5.0     # was 8.0
SERVE_DURATION_S = 12.0        # serve_attach, serve_checkpoint; was 20.0
OBS_HOST_STEPS = 256           # obs_train_host; was 512
TIER_STEPS = 256               # was 512


def phase_host_train(sampling, card: str, steps: int = HOST_TRAIN_STEPS):
    import torch

    argv = ["--device", "cuda", "--steps", str(steps), "--log-every", "128",
            *FULL_WIDTH]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sampling.sample_indices.launches = 0
    with capture_pipelines() as seen:
        final, wall = run_train(argv)
    launches = sampling.sample_indices.launches
    pipe = seen[0]
    if final["step"] < steps:
        raise AssertionError(f"reached {final['step']} of {steps} learner steps")
    state = pipe.comps.state
    tensors = [*state.params.values(), *state.target_params.values(),
               *state.opt_state["nu"].values()]
    if pipe.fused is not None or not all(t.is_cuda for t in tensors):
        raise AssertionError("host-replay train state is not on the card")
    if launches != 0:
        raise AssertionError(f"{launches} sampler kernel launches on the host path, "
                             "which samples on the CPU")
    result = {
        "phase": "host_train", "card": card, "learner_steps": final["step"],
        "loss": final["learner/loss"], "train_state_on": str(tensors[0].device),
        "sampler_launches": launches,
        "learner_steps_per_s": final["step"] / final["train_s"],
        "actor_fps": final["actor_fps"], "steps_per_sec_30s": final["steps_per_sec"],
        "stage_us": final["stage_us"], "train_s": final["train_s"], "wall_s": wall,
        "actor_steps": final["actor_steps"], "replay_size": final["replay_size"],
        "replay_frames_nbytes": pipe.comps.replay.frames_nbytes(),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "cuts": {"steps": f"{steps} for 512 (smoke time)"},
    }
    emit(result)
    return result


def phase_host_sync(sampling, steps: int = 64):
    sampling.sample_indices.launches = 0
    final, wall = run_train(["--mode", "sync", "--device", "cuda", "--steps", str(steps),
                             "--log-every", "100000", *FULL_WIDTH])
    launches = sampling.sample_indices.launches
    if final["step"] < steps:
        raise AssertionError(f"reached {final['step']} of {steps} learner steps")
    if launches != 0:
        raise AssertionError(f"{launches} sampler kernel launches in --mode sync")
    result = {"phase": "host_sync", "learner_steps": final["step"],
              "loss": final["learner/loss"], "sampler_launches": launches,
              "actor_steps": final["actor_steps"], "wall_s": wall}
    emit(result)
    return result


@contextlib.contextmanager
def compute_apps(period_s: float = 0.5):
    """Sample the pids nvidia-smi lists as holding a context on the card,
    every ``period_s`` while the block runs (a list of sets)."""
    seen: list = []
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            res = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60,
            )
            if res.returncode == 0:
                seen.append({int(w) for w in res.stdout.split() if w.isdigit()})
            stop.wait(period_s)

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    try:
        yield seen
    finally:
        stop.set()
        thread.join(120)


def check_workers(phase: str, pool, apps) -> tuple:
    """After a process-actor run: no restarts or worker errors, both workers
    reporting no CUDA initialisation, at most one compute pid on the card
    (this one, the learner's) and no /dev/shm segment of the run left.
    Returns (the workers' reports, the pids nvidia-smi listed)."""
    if pool.restarts or pool.worker_errors:
        raise AssertionError(f"{phase}: {pool.restarts} worker restarts, "
                             f"errors {pool.worker_errors}")
    reports = pool.worker_reports
    if set(reports) != {0, 1} or any(r["cuda_initialized"] for r in reports.values()):
        raise AssertionError(f"{phase}: worker reports {reports}, want both workers "
                             "reporting no CUDA initialisation")
    # A container's pid namespace can hide the list; the reports above hold
    # either way.
    pids = set().union(*apps) if apps else set()
    if max((len(s) for s in apps), default=0) > 1 or len(pids) > 1:
        raise AssertionError(f"{phase}: nvidia-smi listed compute pids {sorted(pids)}, "
                             "want only the learner's")
    leftover = [n for n in os.listdir("/dev/shm") if f"_{os.getpid()}_" in n]
    if leftover:
        raise AssertionError(f"{phase}: segments left in /dev/shm: {leftover}")
    return reports, pids


def latest_versions(pool) -> dict:
    """A copy of ``pool.last_versions`` (worker -> param version of its
    latest chunk), which the pool's pump thread updates."""
    while True:
        try:
            return dict(pool.last_versions)
        except RuntimeError:   # a worker's first chunk landed mid-copy
            continue


@contextlib.contextmanager
def run_until_fresh_chunks(seen, steps: int, grace_s: float = 60.0):
    """Stop the observed process-actor run once it has taken ``steps``
    learner steps and both workers have delivered a chunk acted with a
    published param version (> 1), or ``grace_s`` after it reached
    ``steps`` if that never happens (the phase's check then fails).  The
    run ends after the call or step in progress, with its final record."""
    stop = threading.Event()

    def loop():
        reached = None
        while not stop.wait(0.02):
            if not seen or seen[0].worker is None:
                continue
            pipe = seen[0]
            if pipe._learner_step < steps:
                continue
            reached = reached or time.monotonic()
            versions = latest_versions(pipe.worker.pool)
            fresh = set(versions) == {0, 1} and min(versions.values()) > 1
            if fresh or time.monotonic() - reached > grace_s:
                pipe.stop_event.set()
                return

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join(10)


def phase_process(sampling, card: str, device_replay: bool, steps: int = 512):
    """``train.main --set actor.mode=process --set actor.num_workers=2`` at
    the width of phase 5, on the device-replay path (``proc_train``) or the
    host-replay path (``proc_host_train``)."""
    import torch

    phase = "proc_train" if device_replay else "proc_host_train"
    # Workers poll the param buffer every 100 fleet steps (500 by default).
    # The graphed learner takes 512 steps in under a second, often before a
    # worker has polled and flushed a chunk acted with a published version,
    # so the run goes on past ``steps`` (up to 64×) until both workers have.
    argv = ["--device", "cuda", "--steps", str(64 * steps), "--log-every", "128",
            "--set", "actor.mode=process", "--set", "actor.num_workers=2",
            "--set", "actor.sync_every=100", *FULL_WIDTH]
    if device_replay:
        argv += ["--set", "learner.device_replay=true",
                 "--set", "learner.steps_per_call=128",
                 "--set", "learner.ingest_block=256"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sampling.sample_indices.launches = 0
    with capture_pipelines() as seen, compute_apps() as apps, \
            run_until_fresh_chunks(seen, steps):
        final, wall = run_train(argv)
    launches = sampling.sample_indices.launches
    pipe = seen[0]
    pool = pipe.worker.pool
    if final["step"] < steps:
        raise AssertionError(f"{phase}: reached {final['step']} of {steps} learner steps")
    want = final["step"] if device_replay else 0
    if launches != want:
        raise AssertionError(f"{phase}: {launches} sampler kernel launches, want {want}")
    if set(pool.last_versions) != {0, 1} or min(pool.last_versions.values()) <= 1:
        raise AssertionError(f"{phase}: latest chunk versions by worker "
                             f"{pool.last_versions}, want both workers past version 1")
    reports, pids = check_workers(phase, pool, apps)
    transport = pool.transport_stats()
    result = {
        "phase": phase, "card": card, "learner_steps": final["step"],
        "loss": final["learner/loss"], "sampler_launches": launches,
        "learner_steps_per_s": final["step"] / final["train_s"],
        "actor_fps": final["actor_fps"], "steps_per_sec_30s": final["steps_per_sec"],
        "stage_us": final["stage_us"], "train_s": final["train_s"], "wall_s": wall,
        "actor_steps": final["actor_steps"], "replay_size": final["replay_size"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "param_version": final["param_version"], "last_versions": pool.last_versions,
        "chunks_by_worker": pool.chunks_by_worker,
        "transport": {k: transport[k] for k in ("chunks", "bytes", "transitions",
                                                "chunk_latency_ms", "ring_full_waits",
                                                "salvaged_records", "torn_records")},
        "workers": {w: {"threads": r["threads"], "env_steps": r["env_steps"],
                        "collect_s": r["collect_s"],
                        "env_steps_per_s": r["env_steps"] / max(r["collect_s"], 1e-9)}
                    for w, r in sorted(reports.items())},
        "smi_compute_pids": sorted(pids), "smi_samples": len(apps),
        "learner_pid": os.getpid(), "cpu_count": os.cpu_count(),
        "usable_cpus": len(os.sched_getaffinity(0)),
    }
    if not device_replay:
        result["replay_frames_nbytes"] = pipe.comps.replay.frames_nbytes()
    emit(result)
    return result


def phase_dedup_parity(sampling):
    """The frame-dedup ring on the card against the same ring on the CPU:
    C = 4 096 slots, Cf = 5 120 frames, catch:84 frames from a seeded fleet
    (a small random MLP picks the actions), more than three frame-ring
    wraps.  Integer priorities (α = 1): masses exact, so sampled indices
    must be identical.  Then one fused dedup call at full width."""
    import torch

    from ape_x_dqn_tpu_torch.actors.pool import ActorFleet, LocalParamSource
    from ape_x_dqn_tpu_torch.envs import make_env
    from ape_x_dqn_tpu_torch.learner.train_step import init_train_state, make_optimizer
    from ape_x_dqn_tpu_torch.models.dueling import build_network
    from ape_x_dqn_tpu_torch.replay.device_dedup import dedup_sample_many
    from ape_x_dqn_tpu_torch.runtime.fused_dedup import FusedDedupLearner

    t0 = time.monotonic()
    rng = np.random.default_rng(SEED)
    C, obs_shape, A, K, B = 4096, (84, 84, 1), 3, 4, 32
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        actor_net = build_network("mlp", A, obs_shape, hidden_sizes=(16,))
        net = build_network("conv", A, obs_shape, compute_dtype=torch.float32)
    fleet = ActorFleet([lambda i=i: make_env("catch:84", seed=SEED + i) for i in range(8)],
                       actor_net, seed=SEED, device="cpu", emit_dedup=True)
    fleet.sync_params(LocalParamSource(dict(actor_net.state_dict())))
    chunks, _ = fleet.collect(2300)   # ~18 400 frames: 3.6 wraps of Cf
    learners = {}
    for dev in ("cpu", "cuda"):
        opt = make_optimizer("rmsprop")
        learners[dev] = FusedDedupLearner(
            net, opt, init_train_state(net, opt, seed=SEED, device=dev), obs_shape,
            capacity=C, batch_size=B, steps_per_call=K, ingest_block=512,
            priority_exponent=1.0, target_sync_freq=K, sample_ahead=True,
            frame_ratio=1.25, device=dev)
    cpu, gpu = learners["cpu"], learners["cuda"]
    Cf = gpu.replay.frame_capacity

    def compare(what):
        for f in ("mass", "obs_ref", "next_ref"):
            if not torch.equal(getattr(cpu.replay, f), getattr(gpu.replay, f).cpu()):
                raise AssertionError(f"dedup ring on the card differs from the CPU "
                                     f"ring in {f} after {what}")
        if (cpu.replay.cursor, cpu.replay.count, cpu.replay.fcount) != (
                gpu.replay.cursor, gpu.replay.count, gpu.replay.fcount):
            raise AssertionError(f"dedup ring counters differ after {what}")

    sampling.sample_indices.launches = 0
    ingests = 0
    for i, c in enumerate(chunks):
        prio = rng.integers(1, 20, len(c.priorities)).astype(np.float32)
        rows = []
        for lrn in (cpu, gpu):
            lrn.add_chunk(prio, c.transitions)
            rows.append(lrn.ingest_staged(drain=i == len(chunks) - 1))
        if rows[0] != rows[1]:
            raise AssertionError(f"chunk {i}: {rows} rows ingested on CPU / card")
        if rows[0]:
            ingests += 1
            compare(f"ingest {ingests}")
    wraps = gpu.stager.shipped_f / Cf
    if wraps < 3:
        raise AssertionError(f"frame ring wrapped {wraps:.2f} times, want >= 3")
    size = gpu.size
    dead = int((gpu.replay.mass[:size] == 0).sum())
    # Sampling on integer masses: identical indices, byte-equal frames.
    u = torch.as_tensor(rng.random((64, B), dtype=np.float32))
    got = {d: dedup_sample_many(lrn.replay, 64, B, 0.4, u=u) for d, lrn in learners.items()}
    if not torch.equal(got["cpu"].indices, got["cuda"].indices.cpu()):
        raise AssertionError("dedup sampler indices differ between card and CPU")
    for f in ("obs", "next_obs", "action", "reward", "discount"):
        a, b = getattr(got["cpu"].transition, f), getattr(got["cuda"].transition, f).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"gathered {f} differs between card and CPU")
    w_err = float((got["cpu"].is_weights - got["cuda"].is_weights.cpu()).abs().max())
    # One fused dedup call at full width, float32 compute, TF32 off: the
    # tolerance of phase_parity.
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        u = torch.as_tensor(rng.random((K, B), dtype=np.float32))
        for lrn in (cpu, gpu):
            lrn.train(0.4, u=u)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    init = {k: v.cpu() for k, v in net.state_dict().items()}
    worst = 0.0
    for k in init:
        d_cpu = cpu.state.params[k] - init[k]
        d_gpu = gpu.state.params[k].cpu() - init[k]
        worst = max(worst, float((d_cpu - d_gpu).abs().max()) / (float(d_cpu.abs().max()) + 1e-12))
    mass_err = float((cpu.replay.mass - gpu.replay.mass.cpu()).abs().max())
    if worst > 1e-3 or mass_err > 1e-4 or w_err > 1e-6:
        raise AssertionError(f"card vs CPU dedup: update error {worst:.3g} of the largest "
                             f"update, mass error {mass_err:.3g}, IS weight error {w_err:.3g}")
    launches = sampling.sample_indices.launches
    if launches != 2:
        raise AssertionError(f"{launches} sampler launches on the card, want 2 (one "
                             "sample, one sample-ahead fused call)")
    result = {"phase": "dedup_parity", "C": C, "Cf": Cf, "chunks": len(chunks),
              "ingests_compared": ingests, "frame_ring_wraps": wraps,
              "frames_shipped": gpu.stager.shipped_f, "transitions": gpu.stager.rows_in,
              "dead_slots": dead, "size": size, "sampled": 64 * B,
              "is_weight_max_abs_err": w_err, "param_update_err_rel": worst,
              "mass_max_abs_err": mass_err, "sampler_launches": launches,
              "tolerance": {"param_update_err_rel": 1e-3, "mass_max_abs_err": 1e-4,
                            "is_weight_max_abs_err": 1e-6},
              "seconds": time.monotonic() - t0}
    emit(result)
    return result


def _parity_rings(layout, dev, rng, C=4096, M=3072):
    """Two identical (train state, ring) pairs at full width on ``dev``."""
    import torch

    from ape_x_dqn_tpu_torch.learner.train_step import init_train_state, make_optimizer
    from ape_x_dqn_tpu_torch.models.dueling import build_network
    from ape_x_dqn_tpu_torch.replay import device as rdev
    from ape_x_dqn_tpu_torch.replay import device_dedup as rdd
    from ape_x_dqn_tpu_torch.types import NStepTransition

    obs_shape = (84, 84, 1)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        net = build_network("conv", 3, obs_shape, compute_dtype=torch.float32)
    opt = make_optimizer("rmsprop")
    frames = torch.as_tensor(rng.integers(0, 256, (M + 3, *obs_shape), dtype=np.uint8),
                             device=dev)
    prio = torch.as_tensor((rng.random(M) + 0.05).astype(np.float32), device=dev)
    cols = dict(action=torch.as_tensor(rng.integers(0, 3, M).astype(np.int32), device=dev),
                reward=torch.as_tensor(rng.normal(size=M).astype(np.float32), device=dev),
                discount=torch.full((M,), 0.97, device=dev))
    pairs = []
    for _ in range(2):
        state = init_train_state(net, opt, seed=SEED, device=dev)
        if layout == "double":
            ring = rdev.init_device_replay(C, obs_shape, device=dev)
            rdev.device_replay_add(ring, NStepTransition(obs=frames[:M], next_obs=frames[3:],
                                                         **cols), prio)
        else:
            ring = rdd.init_dedup_device_replay(C, obs_shape, frame_ratio=1.25, device=dev)
            rdd.dedup_device_add_frames(ring, frames)
            seq = torch.arange(M, dtype=torch.int32, device=dev)
            rdd.dedup_device_add_transitions(ring, seq, seq + 3, cols["action"],
                                             cols["reward"], cols["discount"], prio)
        pairs.append((state, ring))
    return net, opt, pairs


def phase_graph_parity(sampling):
    """The graphed fused call against the eager body on the card."""
    import torch

    from ape_x_dqn_tpu_torch.learner.train_step import build_train_step
    from ape_x_dqn_tpu_torch.profile_fused import profile_call
    from ape_x_dqn_tpu_torch.replay import device as rdev
    from ape_x_dqn_tpu_torch.replay import device_dedup as rdd
    from ape_x_dqn_tpu_torch.runtime.graphed_call import GraphedCall

    t0 = time.monotonic()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    K, B, calls, tol = 16, 32, 3, 1e-3
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cases, launches_total = [], 0
    try:
        for layout in ("double", "dedup"):
            for sample_ahead in (False, True):
                net, opt, ((sg, rg), (se, re)) = _parity_rings(layout, dev, rng)
                step = build_train_step(net, opt, sync_in_step=False)
                knobs = dict(steps_per_call=K, batch_size=B, priority_exponent=0.6,
                             sample_ahead=sample_ahead,
                             sample_many_fn=rdd.dedup_sample_many if layout == "dedup" else None)
                call = GraphedCall(step, target_sync_freq=K, **knobs)
                call.bind(sg, rg)
                init = {k: v.clone() for k, v in sg.params.items()}
                gen = torch.Generator(device=dev).manual_seed(SEED)
                mismatch, loss_err, launches = [], 0.0, 0
                for i in range(calls):
                    u = torch.rand((K, B), generator=gen, device=dev)
                    before = sampling.sample_indices.launches
                    _, _, mg = call(sg, rg, 0.4, u=u)
                    launches += sampling.sample_indices.launches - before
                    ig = call.body.sampled_indices()
                    body = rdev.FusedBody(step.update, se, re, **knobs)
                    me = rdev.run_eager(body, 0.4, u)
                    rdev.finish_call(se, K, K)
                    ie = body.sampled_indices()
                    torch.cuda.synchronize()
                    if sample_ahead and not torch.equal(ig, ie):
                        raise AssertionError(f"graph_parity {layout} sample-ahead call {i}: "
                                             "sampled indices differ from the eager body")
                    if i == 0 and not torch.equal(ig[0], ie[0]):
                        raise AssertionError(f"graph_parity {layout}: step 0 indices differ")
                    mismatch.append(int((ig != ie).sum()))
                    loss_err = max(loss_err, float((mg.loss - me.loss).abs().max())
                                   / (float(me.loss.abs().max()) + 1e-12))
                    if i == 0:
                        # A weight import that rebinds a tensor: the next
                        # call must recapture and stay equal.
                        for state, _ in ((sg, rg), (se, re)):
                            state.params["value.weight"] = state.params["value.weight"].clone()
                worst = 0.0
                for k in init:
                    d_g, d_e = sg.params[k] - init[k], se.params[k] - init[k]
                    worst = max(worst, float((d_g - d_e).abs().max())
                                / (float(d_e.abs().max()) + 1e-12))
                mass_err = float((rg.mass - re.mass).abs().max()) / float(re.mass.abs().max())
                want = calls * (1 if sample_ahead else K)
                case = {"layout": layout, "sample_ahead": sample_ahead, "calls": calls, "K": K,
                        "param_update_err_rel": worst, "mass_err_rel": mass_err,
                        "loss_err_rel": loss_err, "index_mismatches_by_call": mismatch,
                        "captures": call.captures, "sampler_launches": launches}
                if worst > tol or mass_err > tol or loss_err > tol:
                    emit({"phase": "graph_parity", "failed_case": case})
                    raise AssertionError(f"graph_parity {layout} sample_ahead={sample_ahead}: "
                                         f"update error {worst:.3g}, mass error {mass_err:.3g}, "
                                         f"loss error {loss_err:.3g} (tolerance {tol})")
                if call.captures != 2 or launches != want or sg.step != se.step:
                    raise AssertionError(f"graph_parity {layout}: {call.captures} captures "
                                         f"(want 2), {launches} sampler launches (want {want})")
                launches_total += launches
                if layout == "double" and not sample_ahead:
                    # One profiled graphed call: the device's own count of
                    # sampler kernels against the runner's.
                    before = sampling.sample_indices.launches
                    prof = profile_call(lambda: call(sg, rg, 0.4, generator=gen))
                    counted = sampling.sample_indices.launches - before
                    if prof["sampler_kernels"] != counted or counted != K:
                        raise AssertionError(f"profiled graphed call: {prof['sampler_kernels']} "
                                             f"sampler kernels in the trace, {counted} counted, "
                                             f"want {K}")
                    case["profiled_call"] = {k: prof[k] for k in (
                        "call_ms", "device_busy_ms", "device_idle_share", "sampler_kernels")}
                    case["profiled_call"]["counted"] = counted
                cases.append(case)
                del call, sg, rg, se, re
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    result = {"phase": "graph_parity", "C": 4096, "B": B, "cases": cases,
              "math": "float32, TF32 off, cudnn.deterministic",
              "sampler_launches": launches_total,
              "tolerance": {"param_update_err_rel": tol, "mass_err_rel": tol,
                            "loss_err_rel": tol},
              "seconds": time.monotonic() - t0}
    emit(result)
    return result


@contextlib.contextmanager
def timed_fused_calls():
    """CUDA events around every ``FusedDedupLearner.train`` call: each
    call's span on the learner's stream, from the end of the work queued
    before it to the end of its own, and the host monotonic times its
    dispatch began and returned: (start event, end event, t0, t1)."""
    import torch

    from ape_x_dqn_tpu_torch.runtime.fused_dedup import FusedDedupLearner

    spans, train = [], FusedDedupLearner.train

    def timed(self, *args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.monotonic()
        start.record()
        out = train(self, *args, **kwargs)
        end.record()
        spans.append((start, end, t0, time.monotonic()))
        return out

    FusedDedupLearner.train = timed
    try:
        yield spans
    finally:
        FusedDedupLearner.train = train


def config3_argv(steps: int, actors: int = 16, workers: int = 2, depth: int = 1,
                 sync_every: int = 0, warmup: int = DEDUP_WARMUP) -> list:
    """``train.main``'s arguments for config3's learner on one card (the
    dedup phases' configuration; their docstrings list the cuts)."""
    K = DEDUP_K
    return ["--device", "cuda", "--steps", str(steps), "--log-every", str(K),
            "--set", "network=conv", "--set", "env.name=catch:84", "--set", f"seed={SEED}",
            "--set", f"replay.capacity={DEDUP_SLOTS}", "--set", "replay.dedup=true",
            "--set", "replay.frame_ratio=1.25", "--set", "replay.priority_exponent=0.6",
            "--set", "replay.is_exponent=0.4",
            "--set", "learner.device_replay=true", "--set", "learner.sample_ahead=true",
            "--set", f"learner.steps_per_call={K}", "--set", f"learner.ingest_block={K}",
            "--set", "learner.second_moment_dtype=bfloat16",
            "--set", "learner.target_dtype=bfloat16",
            "--set", "learner.q_target_sync_freq=2500", "--set", "learner.publish_every=2500",
            "--set", "learner.replay_sample_size=32",
            "--set", f"learner.min_replay_mem_size={warmup}",
            "--set", "actor.mode=process", "--set", f"actor.num_workers={workers}",
            "--set", f"actor.num_actors={actors}", "--set", "actor.num_steps=3",
            "--set", "actor.flush_every=16", "--set", "actor.sync_every=500",
            "--set", "actor.worker_nice=5",
            "--set", f"learner.pipeline_depth={depth}", "--set", f"learner.sync_every={sync_every}"]


# The tcp transport as tcp_train and remote_join run it.
TCP_ARGS = ["--set", "actor.transport=tcp", "--set", "actor.transport_host=127.0.0.1",
            "--set", "actor.net_coalesce_bytes=262144", "--set", "actor.net_dedup=true"]


def phase_dedup_train(sampling, card: str, calls: int = 2, overlap: bool = False,
                      beside: dict | None = None, central: bool = False, tcp: bool = False,
                      actors: int = 16, phase: str | None = None):
    """``train.main`` with config3's learner (``configs/config3_seaquest_
    256actors_2m.json``) on one card: the frame-dedup ring at 2 000 000
    slots, sample-ahead K = 2048, bf16 second moment and target, process
    actors.  Cut, each listed in the output: catch:84 for Seaquest, 2
    workers × ``actors`` / 2 actors for 8 × 32, warm-up 4 096 for 50 000,
    ``calls`` fused calls, data_parallel 1 for 4.  ``overlap``: the
    overlapped pipeline (``overlap_train``: depth 2, a sync every K steps),
    reported beside ``beside`` (``dedup_train``'s result).  ``central``:
    the workers are paramless and act through the ``PolicyServer`` that
    the runtime hosts on the card (``actor.inference=central``).  ``tcp``:
    the workers feed the learner over loopback tcp (``tcp_train``: 256 KiB
    coalesced frames, in-window frame dedup, the params as delta-or-full
    frames on the same connections); the result then carries the wire's
    counters and a host copy of the trained params under ``_params``."""
    import torch

    K = DEDUP_K
    depth, sync_every = (2, K) if overlap else (1, 0)
    phase = phase or ("overlap_train" if overlap else "dedup_train")
    steps = calls * K
    argv = config3_argv(steps, actors=actors, depth=depth, sync_every=sync_every)
    if central:
        argv += ["--set", "actor.inference=central"]
    if tcp:
        argv += TCP_ARGS
    t0 = time.monotonic()
    gc.collect()   # nothing of an earlier phase may hold device memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sampling.sample_indices.launches = 0
    with capture_pipelines() as seen, compute_apps() as apps, \
            timed_fused_calls() as spans, rtt_after_warmup() as warm_rtt:
        final, wall = run_train(argv)
    launches = sampling.sample_indices.launches
    torch.cuda.synchronize()
    pipe = seen[0]
    fused, pool = pipe.fused, pipe.worker.pool
    if type(fused).__name__ != "FusedDedupLearner":
        raise AssertionError(f"{phase} ran {type(fused).__name__}")
    if final["step"] < steps or len(spans) != calls:
        raise AssertionError(f"{phase}: {final['step']} steps in {len(spans)} fused "
                             f"calls, want {steps} in {calls}")
    if launches != calls:
        raise AssertionError(f"{phase}: {launches} sampler launches in {calls} "
                             "sample-ahead fused calls")
    if fused.graphed_call.captures != 1:
        raise AssertionError(f"{phase}: {fused.graphed_call.captures} captures, want 1")
    pipeline = final.get("pipeline")
    if overlap:
        bound = steps // sync_every + calls // depth + 2
        if pipeline is None or pipeline["inflight"] != 0 or pipeline["host_syncs"] > bound:
            raise AssertionError(f"{phase}: pipeline section {pipeline}, want inflight 0 and "
                                 f"host_syncs <= {bound}")
    elif pipeline is not None:
        raise AssertionError(f"{phase}: the strict loop reported a pipeline section")
    ring = fused.replay
    if ring.capacity != DEDUP_SLOTS:
        raise AssertionError(f"dedup ring of {ring.capacity} slots, want {DEDUP_SLOTS}")
    peak = torch.cuda.max_memory_allocated()
    obs_bytes = int(np.prod(ring.frames.shape[1:]))
    double_store = {"frames": 2 * ring.capacity * obs_bytes, "columns": ring.capacity * 16}
    if peak >= double_store["frames"]:
        raise AssertionError(f"peak device memory {peak} is not below the double-store's "
                             f"frame bytes {double_store['frames']}")
    reports, pids = check_workers(phase, pool, apps)
    inference = check_central(phase, pipe, final, reports, warm_rtt) if central else None
    call_ms = [s.elapsed_time(e) for s, e, *_ in spans]
    size = fused.size
    stager = fused.stager
    transport = pool.transport_stats()
    result = {
        "phase": phase, "card": card, "learner_steps": final["step"],
        "fused_calls": len(spans), "steps_per_call": K, "loss": final["learner/loss"],
        "sampler_launches": launches,
        "learner_steps_per_s_second_call": K / (call_ms[-1] / 1e3),
        "fused_call_ms": call_ms,
        "learner_steps_per_s": final["step"] / final["train_s"], "train_s": final["train_s"],
        "peak_mem_bytes": peak, "mem_at_start_bytes": mem_at_start,
        "mem_at_end_bytes": torch.cuda.memory_allocated(),
        "ring_bytes": ring.nbytes(), "double_store_bytes": double_store,
        "frame_capacity": ring.frame_capacity, "capacity": ring.capacity,
        "replay_size": size, "dead_slots": int((ring.mass[:size] == 0).sum()),
        "dropped_carry": stager.dropped_carry,
        "frames_staged": stager.fseq, "transitions_staged": stager.rows_in,
        "frame_per_transition": stager.fseq / max(stager.rows_in, 1),
        "staged_rows_left": fused.staged_rows, "pipeline": pipeline,
        "stage_us": final["stage_us"],
        "target_dtype": str(next(iter(fused.state.target_params.values())).dtype),
        "nu_dtype": str(next(iter(fused.state.opt_state["nu"].values())).dtype),
        "actor_fps": final["actor_fps"], "actor_steps": final["actor_steps"],
        "param_version": final["param_version"], "last_versions": pool.last_versions,
        "transport": {k: transport[k] for k in ("chunks", "bytes", "transitions",
                                                "chunk_latency_ms", "ring_full_waits",
                                                "salvaged_records", "torn_records")},
        "workers": {w: {"threads": r["threads"], "cuda_initialized": r["cuda_initialized"],
                        "env_steps_per_s": r["env_steps"] / max(r["collect_s"], 1e-9)}
                    for w, r in sorted(reports.items())},
        "smi_compute_pids": sorted(pids),
        "cuts": {"env": "catch:84 for SeaquestNoFrameskip-v4 (no Atari on the machine, A11)",
                 "actors": f"2 workers x {actors // 2} actors for 8 x 32",
                 "min_replay_mem_size": f"{DEDUP_WARMUP} for 50000",
                 "steps": f"{calls} fused calls ({steps} steps) for 2000000",
                 "data_parallel": "1 for 4"},
        "wall_s": wall, "seconds": time.monotonic() - t0,
    }
    if inference is not None:
        result["central"] = inference
    if tcp:
        result["tcp"] = check_tcp(phase, pipe, final, reports, wall)
        result["_params"] = {k: v.detach().to("cpu", copy=True)
                             for k, v in fused.params_for_publish().items()}
    if beside is not None:
        result[f"beside_{beside['phase']}"] = {
            k: beside[k] for k in (
                "staged_rows_left", "learner_steps_per_s", "learner_steps_per_s_second_call",
                "fused_call_ms", "peak_mem_bytes", "workers")}
    emit({k: v for k, v in result.items() if not k.startswith("_")})
    return result


OBS_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "obs_smoke")
# /varz?trace=1 captures in obs_train, each of the default window
# (obs.trace_steps): the first armed between two fused calls, so it starts
# at a call's prologue and holds its sampler kernel; the second armed from
# the controller's thread, wherever the learner is.
OBS_CAPTURES = 2
OBS_TRACE_STEPS = 512


def _get(url: str):
    """(status, body bytes) of one GET; a 503 is a reply, not an error."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class ObsController:
    """Drives the observability plane of a live ``train.main`` run from a
    thread: after the fourth fused call, scrape ``/metrics``, ``/varz`` and
    ``/healthz`` and run ``tools/obs_top.py --varz URL --once``; then
    ``OBS_CAPTURES`` times ``/varz?trace=1``, each waited for until its
    ``done`` and one fused call more, with ``/healthz`` scraped every half
    second all the while (the first trigger is sent from the learner's
    thread just before a fused call begins: armed between two calls); then
    SIGKILL worker 1 and wait for its post-mortem file, its respawn and its
    first chunks; then stop the run after ``OBS_CALLS_AFTER`` more calls.  The times of
    these moments (host monotonic) are recorded, so the rate can leave the
    captures and the respawn out."""

    def __init__(self, seen: list, K: int, pm_dir: str):
        self.seen, self.K, self.pm_dir = seen, K, pm_dir
        self.out: dict = {"times": {}}
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._arm_url = None        # set: the learner triggers before its next call
        self._armed = threading.Event()

    def __enter__(self):
        from ape_x_dqn_tpu_torch.runtime.fused_dedup import FusedDedupLearner

        train, ctl = FusedDedupLearner.train, self
        self._train = train

        def arming(learner, *args, **kwargs):
            if ctl._arm_url is not None:
                ctl.out["armed_trigger"] = _get(ctl._arm_url)
                ctl._arm_url = None
                ctl._armed.set()
            return train(learner, *args, **kwargs)

        FusedDedupLearner.train = arming
        self._thread.start()
        return self

    def __exit__(self, *exc):
        from ape_x_dqn_tpu_torch.runtime.fused_dedup import FusedDedupLearner

        self._stop.set()
        self._thread.join(300)
        FusedDedupLearner.train = self._train

    def _wait(self, cond, what: str, timeout: float = 300.0):
        deadline = time.monotonic() + timeout
        while not cond():
            if self._stop.is_set() or time.monotonic() > deadline:
                raise AssertionError(f"obs_train: timed out waiting for {what}")
            time.sleep(0.02)

    def _poll_healthz(self, url: str, t0: float, done) -> list:
        """``/healthz`` every half second until ``done()``: (seconds since
        ``t0``, status code, the learner's heartbeat age)."""
        codes = []
        while not done():
            if self._stop.is_set():
                raise AssertionError("obs_train: the run ended during a capture")
            t = time.monotonic() - t0
            code, body = _get(f"{url}/healthz")
            age = json.loads(body)["components"].get("learner", {}).get("age_s")
            codes.append((round(t, 3), code, age))
            time.sleep(0.5)
        return codes

    def _run(self):
        try:
            self._drive()
        except BaseException as e:  # noqa: BLE001 — raised by the phase
            self.error = e
        finally:
            if self.seen:
                self.seen[0].stop_event.set()

    def _drive(self):
        out, t = self.out, self.out["times"]
        self._wait(lambda: self.seen and self.seen[0].obs_server is not None, "the exporter")
        pipe = self.seen[0]
        url = out["url"] = pipe.obs_server.url
        self._wait(lambda: pipe.learner_step >= 4 * self.K, "four fused calls")
        t["scrape"] = time.monotonic()
        out["metrics"] = _get(f"{url}/metrics")
        out["varz"] = _get(f"{url}/varz")
        out["healthz"] = _get(f"{url}/healthz")
        top = subprocess.run([sys.executable, os.path.join(REPO_DIR, "tools", "obs_top.py"),
                              "--varz", url, "--once"],
                             capture_output=True, text=True, timeout=120)
        out["obs_top"] = {"rc": top.returncode, "stdout": top.stdout, "stderr": top.stderr}
        out["captures"] = []
        for i in range(OBS_CAPTURES):
            cap = {"t_trigger": time.monotonic(), "armed_at_call": i == 0}
            if i == 0:
                self._arm_url = f"{url}/varz?trace=1"
                self._wait(self._armed.is_set, "the learner's trigger")
                status, body = out.pop("armed_trigger")
            else:
                status, body = _get(f"{url}/varz?trace=1")
            cap["trigger"] = json.loads(body)["trace"] if status == 200 else {"status": status}
            cap["healthz"] = self._poll_healthz(url, cap["t_trigger"], lambda: pipe.trace_on_demand
                                                .status()["state"] not in ("idle", "capturing"))
            cap["t_done"] = time.monotonic()
            cap["trace"] = pipe.trace_on_demand.status()
            step = pipe.learner_step
            cap["healthz_after"] = self._poll_healthz(url, cap["t_trigger"],
                                                      lambda: pipe.learner_step >= step + self.K)
            cap["t_after"] = time.monotonic()
            out["captures"].append(cap)
        pool = pipe.worker.pool
        victim = pool._procs[1]
        chunks = pool.chunks_by_worker.get(1, 0)
        t["kill"] = time.monotonic()
        os.kill(victim.pid, signal.SIGKILL)
        out["killed_pid"] = victim.pid
        self._wait(lambda: os.path.isdir(self.pm_dir) and any(
            f.endswith(".json") for f in os.listdir(self.pm_dir)), "the post-mortem file")
        t["postmortem"] = time.monotonic()
        self._wait(lambda: pool._procs[1] is not victim and pool._procs[1].is_alive()
                   and pool.chunks_by_worker.get(1, 0) > chunks + 1, "worker 1 fed again")
        t["refed"] = time.monotonic()
        out["varz_after"] = _get(f"{url}/varz")
        out["healthz_after"] = _get(f"{url}/healthz")
        step = pipe.learner_step
        self._wait(lambda: pipe.learner_step >= step + OBS_CALLS_AFTER * self.K,
                   f"{OBS_CALLS_AFTER} call after the respawn")


def phase_obs_train(sampling, card: str, beside: dict) -> dict:
    """``dedup_train``'s learner (config3's, the same cuts) with the
    observability plane driven while it trains (``ObsController``):
    ``obs.export_port=0``, the supervisor, post-mortems and traces under
    ``build/obs_smoke/``.  Checks: every endpoint answers and ``/healthz``
    is 200 with every component fresh; ``obs_top --once`` exits 0 with a
    frame; each ``/varz?trace=1`` capture is ``done`` and traced exactly
    the default window (``OBS_TRACE_STEPS`` steps, inside a 2048-step
    call), holds device kernels, its graph replays equal the runner's
    count over the window and its sampler kernels, all launched in the
    window, the wrapper's count (0 or 1); the capture armed between two
    calls holds its call's sampler kernel; ``/healthz`` reads 200 at every
    scrape from each trigger to the end of the call after its ``done``;
    the SIGKILLed worker's post-mortem holds its salvaged events, it is
    respawned and ``supervisor/respawns`` reads 1 on ``/varz``; one sampler
    launch per fused call; no /dev/shm segment left.  Reports the top
    device ops and idle share of the first capture, each capture's cost
    (the learner's stalls, the export, the summary, the records, the call
    after it) and the device record that leads its launch most, and
    learner steps/s over the calls outside the captures and the respawn,
    beside ``dedup_train``'s."""
    import shutil

    import torch

    K = DEDUP_K
    shutil.rmtree(OBS_ROOT, ignore_errors=True)
    pm_dir = os.path.join(OBS_ROOT, "postmortem")
    argv = config3_argv(64 * K) + [
        "--set", "obs.export_port=0", "--set", "supervisor.enabled=true",
        "--set", f"obs.postmortem_dir={pm_dir}",
        "--set", f"obs.trace_dir={os.path.join(OBS_ROOT, 'traces')}"]
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sampling.sample_indices.launches = 0
    with capture_pipelines() as seen, timed_fused_calls() as spans, \
            ObsController(seen, K, pm_dir) as ctl:
        final, wall = run_train(argv)
    launches = sampling.sample_indices.launches
    torch.cuda.synchronize()
    if ctl.error is not None:
        raise AssertionError(f"obs_train: {ctl.error}") from ctl.error
    out, t = ctl.out, ctl.out["times"]
    pipe = seen[0]
    fused, pool = pipe.fused, pipe.worker.pool
    calls = len(spans)
    if launches != calls or final["step"] != calls * K:
        raise AssertionError(f"obs_train: {launches} sampler launches, {final['step']} steps "
                             f"in {calls} fused calls")
    # The endpoints while it trained.
    for name in ("metrics", "varz", "healthz"):
        if out[name][0] != 200:
            raise AssertionError(f"obs_train: /{name} answered {out[name][0]}")
    health = json.loads(out["healthz"][1])
    if health["status"] != "ok" or not all(c["ok"] for c in health["components"].values()) \
            or not {"learner", "ingest", "supervisor"} <= set(health["components"]):
        raise AssertionError(f"obs_train: /healthz {health}")
    text = out["metrics"][1].decode()
    for series in ("apex_learner_step ", "apex_supervisor_respawns_total 0",
                   "apex_workers_0_env_steps ", "apex_host_rss_bytes "):
        if series not in text:
            raise AssertionError(f"obs_train: /metrics lacks {series!r}")
    top = out["obs_top"]
    if top["rc"] != 0 or not top["stdout"].startswith("== apex-tpu obs_top ==") \
            or "-- workers (2)" not in top["stdout"]:
        raise AssertionError(f"obs_train: obs_top {top}")
    # The captures: the default window, exact, inside a call.
    if pipe.cfg.obs.trace_steps != OBS_TRACE_STEPS or pipe.cfg.obs.heartbeat_stale_s != 15.0:
        raise AssertionError(f"obs_train: obs config {pipe.cfg.obs}")
    for i, cap in enumerate(out["captures"]):
        trace = cap["trace"]
        summary = trace.get("summary") or {}
        if trace.get("state") != "done" or not trace.get("trace_started") \
                or trace.get("steps_traced") != OBS_TRACE_STEPS:
            raise AssertionError(f"obs_train: capture {i}: trace {trace}")
        launched = trace["counters"]["sampler_launches"]
        if not summary.get("device_events") \
                or summary.get("graph_replays") != trace["counters"]["graph_replays"] \
                or launched not in (0, 1) \
                or summary["sampler_kernels_launched_in_window"] != launched \
                or summary["sampler_kernels"] != launched \
                or (cap["armed_at_call"] and launched != 1):
            raise AssertionError(f"obs_train: capture {i}: sampler kernels and replays "
                                 f"against {trace['counters']} counted, summary "
                                 f"{ {k: v for k, v in summary.items() if k != 'top_device_ms'} }")
        # Every scrape answered (a timeout raises in the controller) and
        # read 200, from the trigger to the end of the call after done.
        scrapes = cap["healthz"] + cap["healthz_after"]
        if not cap["healthz_after"] or any(code != 200 for _, code, _ in scrapes):
            raise AssertionError(f"obs_train: capture {i}: /healthz during {cap['healthz']}, "
                                 f"after done {cap['healthz_after']}")
    # The kill.
    files = sorted(f for f in os.listdir(pm_dir) if f.endswith(".json"))
    if len(files) != 1 or not files[0].startswith("worker1-salvage-"):
        raise AssertionError(f"obs_train: post-mortem files {files}")
    with open(os.path.join(pm_dir, files[0])) as f:
        pm = json.load(f)
    if pm["stats"]["pid"] != out["killed_pid"] or not pm["events"] \
            or pm["events"][0]["kind"] != "spawn" or pm["stats"]["env_steps"] <= 0:
        raise AssertionError(f"obs_train: post-mortem {pm}")
    varz_after = json.loads(out["varz_after"][1])
    if varz_after["supervisor/respawns"]["total"] != 1 or pool.restarts != 1 \
            or final["supervisor"]["respawns"] != 1:
        raise AssertionError(f"obs_train: respawns {varz_after['supervisor/respawns']}, "
                             f"pool {pool.restarts}, final {final['supervisor']}")
    if any(r["cuda_initialized"] for r in pool.worker_reports.values()):
        raise AssertionError(f"obs_train: worker reports {pool.worker_reports}")
    leftover = [n for n in os.listdir("/dev/shm") if f"_{os.getpid()}_" in n]
    if leftover:
        raise AssertionError(f"obs_train: segments left in /dev/shm: {leftover}")
    # Rates: the calls whose dispatch overlaps neither a capture (trigger to
    # the end of the call after its done) nor the kill-to-refed interval,
    # against dedup_train's calls.
    call_ms = [s.elapsed_time(e) for s, e, *_ in spans]
    busy = [(c["t_trigger"], c["t_after"]) for c in out["captures"]] + [(t["kill"], t["refed"])]
    quiet = [i for i, (_, _, a, b) in enumerate(spans)
             if i > 0   # the first call fills the pipeline
             and all(b < lo - 0.1 or a > hi + 0.1 for lo, hi in busy)]

    def overlapping(lo, hi):
        return [i for i, (_, _, a, b) in enumerate(spans) if a < hi and b > lo]
    rate = K * len(quiet) / (sum(call_ms[i] for i in quiet) / 1e3) if quiet else None
    base_ms = beside["fused_call_ms"]
    base_rate = K * len(base_ms) / (sum(base_ms) / 1e3)
    shutil.rmtree(OBS_ROOT, ignore_errors=True)
    result = {
        "phase": "obs_train", "card": card, "learner_steps": final["step"],
        "fused_calls": calls, "sampler_launches": launches, "loss": final["learner/loss"],
        "learner_steps_per_s_quiet_calls": rate, "quiet_calls": quiet,
        "learner_steps_per_s_second_call": K / (call_ms[1] / 1e3),
        "cuts": {"calls_after_respawn": f"{OBS_CALLS_AFTER} for 3 (smoke time)"},
        "fused_call_ms": call_ms,
        "beside_dedup_train": {
            "learner_steps_per_s_calls": base_rate,
            "learner_steps_per_s_second_call": beside["learner_steps_per_s_second_call"],
            "learner_steps_per_s": beside["learner_steps_per_s"],
            "peak_mem_bytes": beside["peak_mem_bytes"]},
        "quiet_over_dedup_train": rate / base_rate if rate else None,
        "second_call_over_dedup_train":
            (K / (call_ms[1] / 1e3)) / beside["learner_steps_per_s_second_call"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "mem_at_start_bytes": mem_at_start,
        "captures": [{
            "steps_traced": c["trace"]["steps_traced"], "window_s": c["trace"]["window_s"],
            "counters": c["trace"]["counters"], "cost": c["trace"]["cost"],
            "trigger_to_done_s": c["t_done"] - c["t_trigger"],
            "calls_ms": {i: call_ms[i] for i in overlapping(c["t_trigger"], c["t_after"])},
            "armed_at_call": c["armed_at_call"],
            "records": c["trace"]["summary"]["device_events"],
            "stop_ms": c["trace"]["cost"]["stop_ms"],
            "export_ms": c["trace"]["cost"]["export_ms"],
            "healthz": {"scrapes": len(c["healthz"]),
                        "longest_answer_gap_s": max(b[0] - a[0] for a, b in zip(
                            c["healthz"], c["healthz"][1:])) if len(c["healthz"]) > 1 else None,
                        "max_learner_age_s": max(a for *_, a in c["healthz"]),
                        "scrapes_after_done": len(c["healthz_after"])},
            **{k: c["trace"]["summary"][k] for k in (
                "device_events", "device_busy_ms", "device_span_ms", "idle_share",
                "sampler_kernels", "sampler_kernels_launched_in_window", "graph_replays",
                "device_clock_lead_ms", "device_clock_lead", "device_records_before_launch")},
            **({"top_device_ms": c["trace"]["summary"]["top_device_ms"]} if not n else {}),
        } for n, c in enumerate(out["captures"])],
        "healthz": health, "obs_top_lines": top["stdout"].splitlines()[:3],
        "postmortem": {"file": files[0], "events": len(pm["events"]),
                       "events_torn": pm["events_torn"], "env_steps": pm["stats"]["env_steps"],
                       "ring": pm["ring"]},
        "respawn_s": {"kill_to_postmortem": t["postmortem"] - t["kill"],
                      "kill_to_refed": t["refed"] - t["kill"]},
        "wall_s": wall, "seconds": time.monotonic() - t0,
    }
    emit(result)
    return result


def phase_obs_host(sampling, card: str, steps: int = OBS_HOST_STEPS) -> dict:
    """The host-replay path with 2 worker processes and every chunk traced
    (``obs.trace_sample_rate=1.0``), ``steps`` learner steps at full width:
    every finished lineage span is monotone (``t_act <= t_ingest <=
    t_first_sample <= t_trained``, the last stamped at the card's deferred
    priority write-back), spans come from both workers, and the
    age-at-sample histogram counts every sampled row (steps × B); no
    sampler launch (the host path samples on the CPU); no /dev/shm segment
    left."""
    import torch

    argv = ["--device", "cuda", "--steps", str(steps), "--log-every", "128",
            "--set", "actor.mode=process", "--set", "actor.num_workers=2",
            "--set", "obs.trace_sample_rate=1.0", *FULL_WIDTH]
    torch.cuda.synchronize()
    sampling.sample_indices.launches = 0
    out = io.StringIO()
    from ape_x_dqn_tpu_torch import train

    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv)
    wall = time.monotonic() - t0
    launches = sampling.sample_indices.launches
    records = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    final = records[-1]
    spans = [r for r in records if r.get("event") == "lineage_span"]
    if rc != 0 or not final.get("final") or final["step"] != steps or launches:
        raise AssertionError(f"obs_train_host: rc {rc}, {final.get('step')} steps, "
                             f"{launches} sampler launches")
    bad = [s for s in spans if not (s["t_act"] <= s["t_ingest"] <= s["t_first_sample"]
                                    <= s["t_trained"])]
    lineage = final.get("lineage") or {}
    B = 32
    if not spans or bad or {s["wid"] for s in spans} != {0, 1} \
            or lineage.get("age_at_sample", {}).get("count") != steps * B \
            or lineage.get("traces_completed") != len(spans):
        raise AssertionError(f"obs_train_host: {len(spans)} spans, {len(bad)} not monotone "
                             f"(first {bad[:1]}), workers {sorted({s['wid'] for s in spans})}, "
                             f"lineage {lineage}")
    leftover = [n for n in os.listdir("/dev/shm") if f"_{os.getpid()}_" in n]
    if leftover:
        raise AssertionError(f"obs_train_host: segments left in /dev/shm: {leftover}")
    ms = {k: [s[k] for s in spans] for k in ("act_to_ingest_ms", "ingest_to_first_sample_ms",
                                             "first_sample_to_trained_ms", "act_to_trained_ms")}
    result = {"phase": "obs_train_host", "card": card, "learner_steps": final["step"],
              "cuts": {"steps": f"{steps} for 512 (smoke time)"},
              "sampler_launches": launches, "spans": len(spans), "spans_not_monotone": 0,
              "traces_open": lineage["traces_open"],
              "traces_abandoned": lineage["traces_abandoned"],
              "age_at_sample": {k: v for k, v in lineage["age_at_sample"].items()
                                if k != "buckets_s"},
              "span_ms_p50": {k: float(np.percentile(v, 50)) for k, v in ms.items()},
              "span_ms_max": {k: max(v) for k, v in ms.items()},
              "learner_steps_per_s": final["step"] / final["train_s"], "wall_s": wall}
    emit(result)
    return result


def check_tcp(phase: str, pipe, final: dict, reports: dict, wall: float) -> dict:
    """A run over the tcp transport: no /dev/shm segment of the pool, the
    workers' params from the wire, 0 torn frames, every record the workers
    sent ingested; returns the wire's numbers: bytes/s and per transition,
    coalescing and dedup ratios, the param pushes full and delta (and, for
    the last publish, the 64 KiB pages that changed: what a delta would
    have shipped), ``version_lag`` (published version minus the oldest
    version a worker's latest chunk was acted with)."""
    pool = pipe.worker.pool
    net, xp = final["net"], final["xp_transport"]
    if pool.transport_kind != "tcp" or pool.shm_accounting()["shm_segments"]:
        raise AssertionError(f"{phase}: transport {pool.shm_accounting()}")
    if any(r["param_source"] != "net" for r in reports.values()):
        raise AssertionError(f"{phase}: worker param sources {reports}")
    if net["torn_frames"] or xp["torn_records"] or net["rejects"] \
            or net["frames_in"] != xp["chunks"]:
        raise AssertionError(f"{phase}: net {net}, xp_transport {xp}")
    tr = pool._transport.net
    prev, new = tr._param_prev, tr._param_payload
    page = 64 << 10
    changed = total = None
    if prev is not None and new is not None and len(prev) == len(new):
        total = (len(new) + page - 1) // page
        changed = sum(prev[i * page:(i + 1) * page] != new[i * page:(i + 1) * page]
                      for i in range(total))
    train_s = max(final["train_s"], 1e-9)
    return {
        "wire_bytes": net["bytes_in"], "logical_bytes": net["logical_bytes_in"],
        "wire_bytes_per_s_over_train_s": net["bytes_in"] / train_s,
        "wire_bytes_per_s_over_wall": net["bytes_in"] / wall,
        "wire_bytes_per_transition": net["bytes_in"] / max(xp["transitions"], 1),
        "wire_over_logical": net["wire_over_logical"],
        "records_per_frame": net["records_per_frame"], "wire_frames": net["wire_frames_in"],
        "torn_frames": net["torn_frames"], "reconnects": net["reconnects"],
        "param_pushes": net["param_pushes"], "param_full": net["param_full"],
        "param_delta": net["param_delta"], "param_bytes": net["param_bytes"],
        "param_last_push": net["param_last_push"], "param_fanout_ms_mean":
            net["param_fanout_ms_mean"], "snapshot_bytes": len(new) if new else None,
        "last_publish_pages_changed": changed, "pages": total,
        "version_lag": final["param_version"] - min(latest_versions(pool).values()),
        "chunk_latency_ms": xp["chunk_latency_ms"],
    }


@contextlib.contextmanager
def rtt_after_warmup():
    """The central workers' round-trip histogram states (worker -> state)
    when the learner's warm-up ends: the run's final states less these are
    the round trips taken while the learner replayed its calls."""
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline

    snap, wait = {}, AsyncPipeline._wait_for_warmup

    def observed(self, *args, **kwargs):
        out = wait(self, *args, **kwargs)
        pool = getattr(self.worker, "pool", None)
        if pool is not None:
            snap.update({w: dict(st["rtt_state"]) for w, st in
                         list(pool.inference_by_worker.items())})
        return out

    AsyncPipeline._wait_for_warmup = observed
    try:
        yield snap
    finally:
        AsyncPipeline._wait_for_warmup = wait


def rtt_summary(final_states: dict, warm: dict) -> dict:
    """p50/p99 (ms) of the round trips in ``final_states`` beyond ``warm``."""
    from ape_x_dqn_tpu_torch.utils.metrics import LatencyHistogram

    hist = LatencyHistogram()
    for w, st in final_states.items():
        base = warm.get(w, {"counts": [0] * len(st["counts"]), "count": 0, "sum": 0.0})
        hist.merge_state({"counts": [a - b for a, b in zip(st["counts"], base["counts"])],
                          "count": st["count"] - base["count"],
                          "sum": st["sum"] - base["sum"], "max": st["max"]})
    return hist.summary()


def check_central(phase: str, pipe, final: dict, reports: dict, warm_rtt: dict) -> dict:
    """A central run: paramless workers (no param buffer, no params, no CUDA),
    every fleet step's actions from the card's server (completed selects ==
    fleet steps, no fallback, the server's per-worker rows cover them), no
    torn frame or reply; returns what the phase reports of it."""
    pool = pipe.worker.pool
    server, net = pipe._central_server, pipe._central_net
    if pool.buffer is not None or pool.store is not None:
        raise AssertionError(f"{phase}: the central pool made a param buffer")
    if server is None or server.device.type != "cuda":
        raise AssertionError(f"{phase}: no PolicyServer on the card")
    per_worker = {}
    net_stats = net.stats()
    for w, r in sorted(reports.items()):
        inf = r["inference"]
        steps = r["env_steps"] // (pool.cfg.actor.num_actors // pool.num_workers)
        served_rows = net_stats["sources"].get(str(w), {}).get("rows", 0)
        if r["param_buffer"] or r["held_params"] or r["cuda_initialized"]:
            raise AssertionError(f"{phase}: worker {w} report {r}")
        if inf["selects"] - inf["outages"] != steps or inf["fallback_steps"] \
                or served_rows < r["env_steps"]:
            raise AssertionError(f"{phase}: worker {w} took {steps} fleet steps, "
                                 f"{inf['selects']} selects ({inf['outages']} cut), "
                                 f"{inf['fallback_steps']} fallback, server rows {served_rows}")
        per_worker[w] = {"selects": inf["selects"], "rows": inf["rows"],
                         "rtt": inf["rtt"], "stall_ms": inf["stall_ms"]}
    section = final["inference"]
    if section["torn_replies"] or net_stats["torn_frames"] or section["errors"]:
        raise AssertionError(f"{phase}: torn replies {section['torn_replies']}, "
                             f"torn frames {net_stats['torn_frames']}, errors {section['errors']}")
    stats = server.stats()
    return {
        "inference": {k: v for k, v in section.items() if k != "rtt_exemplars"},
        "rtt_while_learning": rtt_summary(
            {w: r["inference"]["rtt_state"] for w, r in reports.items()}, warm_rtt),
        "workers": per_worker,
        "server": {"batch_hist": stats["batch_hist"], "served_total": stats["served_total"],
                   "latency": stats["latency"], "reloads": stats["reloads"],
                   "param_version": stats["param_version"],
                   "forward_times": server.forward_times()},
        "net": {k: net_stats[k] for k in ("requests", "replies", "inference_rows",
                                          "torn_frames", "bad_hellos", "shed", "errors",
                                          "bytes_in", "bytes_out", "latency")},
    }


def phase_serve_parity(card: str, reps: int = 50):
    """The card's ``PolicyServer`` against the port's plain CPU forward at
    full width (conv 64/64/64, hidden 512, 84×84×1), float32, TF32 off: for
    every batch size 1..32 (one batch each), q within 1e-4 of the largest
    |q| and actions equal wherever the top-2 gap exceeds 2e-4 of it.  Then
    a hot reload under load: 4 clients while 3 versions are published, no
    request dropped, each reply's q equal to its claimed version's CPU
    forward.  Last, each bucket's host and device time per batch at the
    default bf16 compute, ``reps`` batches per bucket."""
    import torch

    from ape_x_dqn_tpu_torch.envs import make_env
    from ape_x_dqn_tpu_torch.models.dueling import build_network
    from ape_x_dqn_tpu_torch.runtime.param_store import ParamStore
    from ape_x_dqn_tpu_torch.serving.server import PolicyServer

    obs_shape, A = (84, 84, 1), make_env("catch:84").num_actions

    def params_of(seed):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = build_network("conv", A, obs_shape)
        return {k: v.detach().clone() for k, v in net.state_dict().items()}

    def cpu_q(net, params, obs):
        with torch.no_grad():
            return net.apply_params(params, torch.from_numpy(obs)).q.numpy()

    t0 = time.monotonic()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    net = build_network("conv", A, obs_shape, compute_dtype=torch.float32)
    rng = np.random.default_rng(SEED)
    worst, mismatched, ties = 0.0, 0, 0
    try:
        p0 = params_of(SEED)
        server = PolicyServer(net, p0, max_batch=32, max_wait_ms=200.0, device="cuda")
        server.warmup(obs_shape)
        server.start()
        try:
            for n in range(1, 33):
                obs = rng.integers(0, 256, (n, *obs_shape), dtype=np.uint8)
                res = [f.result(timeout=60) for f in [server.submit(o) for o in obs]]
                q_ref = cpu_q(net, p0, obs)
                q = np.stack([r.q_values for r in res])
                scale = float(np.abs(q_ref).max())
                worst = max(worst, float(np.abs(q - q_ref).max()) / scale)
                top2 = np.sort(q_ref, axis=1)[:, -2:]
                clear = top2[:, 1] - top2[:, 0] > 2e-4 * scale
                ties += int((~clear).sum())
                acts = np.array([r.action for r in res])
                mismatched += int((acts[clear] != q_ref[clear].argmax(axis=1)).sum())
            hist = server.stats()["batch_hist"]
        finally:
            server.close()
        if worst > 1e-4 or mismatched or hist != {str(n): 1 for n in range(1, 33)}:
            raise AssertionError(f"serve_parity: q error {worst} of the largest, "
                                 f"{mismatched} actions differ, batches {hist}")
        # Hot reload under load.
        versions = {0: p0}
        store = ParamStore(p0)
        server = PolicyServer(net, param_source=store, max_batch=32, max_wait_ms=1.0,
                              reload_poll_s=0.02, device="cuda")
        server.warmup(obs_shape)
        server.start()
        results, errors = [], []
        stop = threading.Event()

        def client(seed):
            crng = np.random.default_rng(seed)
            while not stop.is_set():
                o = crng.integers(0, 256, obs_shape, dtype=np.uint8)
                try:
                    results.append((o, server.act(o, timeout=60)))
                except Exception as e:  # noqa: BLE001 — counted, the check fails
                    errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(SEED + i,), daemon=True)
                   for i in range(4)]
        try:
            for t in threads:
                t.start()
            for v in (1, 2, 3):
                time.sleep(0.3)
                versions[v] = params_of(SEED + v)
                store.publish(versions[v])
                deadline = time.monotonic() + 30
                while server.param_version < v and time.monotonic() < deadline:
                    time.sleep(0.005)
            time.sleep(0.3)
        finally:
            stop.set()
            for t in threads:
                t.join(60)
            server.close()
        reload_worst, by_version = 0.0, {}
        for v, params in versions.items():
            group = [(o, r) for o, r in results if r.param_version == v]
            by_version[v] = len(group)
            if group:
                q_ref = cpu_q(net, params, np.stack([o for o, _ in group]))
                q = np.stack([r.q_values for _, r in group])
                reload_worst = max(reload_worst,
                                   float(np.abs(q - q_ref).max() / np.abs(q_ref).max()))
        if errors or sorted(by_version) != [0, 1, 2, 3] or min(by_version.values()) == 0 \
                or reload_worst > 1e-4 or server.reload_count != 3:
            raise AssertionError(f"serve_parity reload: errors {errors[:3]}, replies by "
                                 f"version {by_version}, q error {reload_worst}, "
                                 f"reloads {server.reload_count}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    # Per-bucket times at the runtime's bf16 compute: each bucket alone.
    net16 = build_network("conv", A, obs_shape)
    server = PolicyServer(net16, p0, max_batch=32, max_wait_ms=50.0, device="cuda")
    server.warmup(obs_shape)
    server.start()
    try:
        for b in (1, 2, 4, 8, 16, 32):
            obs = rng.integers(0, 256, (b, *obs_shape), dtype=np.uint8)
            for _ in range(reps):
                for f in [server.submit(o) for o in obs]:
                    f.result(timeout=60)
        times = server.forward_times()
    finally:
        server.close()
    # The same forwards as CUDA-graph replays: the device's own time per
    # batch, against which the eager batch's host time is launch overhead.
    graphed = graphed_forward_ms(net16, p0, obs_shape, reps)
    result = {"phase": "serve_parity", "card": card, "buckets": 32,
              "q_max_err_rel": worst, "q_tolerance_rel": 1e-4,
              "action_gap_tolerance_rel": 2e-4, "near_ties_skipped": ties,
              "actions_differing": mismatched, "reload_replies_by_version": by_version,
              "reload_q_max_err_rel": reload_worst, "reload_errors": len(errors),
              "reloads": 3, "forward_times_bf16": times,
              "graph_replay_device_ms_bf16": graphed,
              "seconds": time.monotonic() - t0}
    emit(result)
    return result


def graphed_forward_ms(net, params, obs_shape, reps: int) -> dict:
    """Device ms of one greedy forward per bucket, captured in a CUDA graph
    and replayed ``reps`` times between two events (a measurement only; the
    server runs its forwards eagerly)."""
    import torch

    from ape_x_dqn_tpu_torch.models.dueling import build_greedy_apply

    apply = build_greedy_apply(net)
    dparams = {k: v.to("cuda") for k, v in params.items()}
    side = torch.cuda.Stream()
    out = {}
    for b in (1, 2, 4, 8, 16, 32):
        x = torch.zeros((b, *obs_shape), dtype=torch.uint8, device="cuda")
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                apply(dparams, x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            apply(dparams, x)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        out[str(b)] = round(start.elapsed_time(end) / reps, 4)
        del graph
    return out


def phase_serve_attach(sampling, card: str, duration: float = SERVE_DURATION_S):
    """``serve.main(["--attach", "--listen", "0", "--clients", "4", ...])``
    on the card: the device-replay learner of phase 5 trains in a thread
    while 4 closed-loop clients act through the server and it hot-reloads
    the learner's publishes.  QPS, latency p50/p99, reloads, 0 client
    errors (exit code 0), a bound socket port."""
    from ape_x_dqn_tpu_torch import serve

    argv = ["--attach", "--listen", "0", "--clients", "4", "--duration", str(duration),
            "--metrics-every", "5", "--device", "cuda", "--steps", "10000000",
            "--set", "learner.device_replay=true", "--set", "learner.steps_per_call=128",
            "--set", "learner.ingest_block=256", "--set", "serving.reload_poll_s=0.25",
            *FULL_WIDTH]
    sampling.sample_indices.launches = 0
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = serve.main(argv)
    wall = time.monotonic() - t0
    recs = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    listen = [r for r in recs if r.get("event") == "serving_listen"]
    served = [r for r in recs if "serve/served_total" in r]
    trainer = [r for r in recs if "step" in r and "serve/served_total" not in r]
    final = served[-1] if served else {}
    if rc != 0 or not listen or not final.get("final") or final["serve/served_total"] == 0 \
            or final["serve/reloads"] < 1:
        raise AssertionError(f"serve_attach: rc {rc}, listen {listen}, final {final}")
    result = {"phase": "serve_attach", "card": card, "duration_s": duration, "wall_s": wall,
              "cuts": {"duration_s": f"{duration} for 20.0 (smoke time)"},
              "port": listen[0]["port"], "served_total": final["serve/served_total"],
              "qps": final["serve/served_total"] / duration,
              "qps_30s": final["serve/qps"],
              "latency_ms": {k: final.get(f"serve/{k}_ms") for k in ("p50", "p95", "p99")},
              "reloads": final["serve/reloads"], "param_version": final["serve/param_version"],
              "batch_hist": final["serve/batch_hist"], "shed": final["serve/shed_total"],
              "learner_steps": trainer[-1]["step"] if trainer else 0,
              "sampler_launches": sampling.sample_indices.launches}
    emit(result)
    return result


# -- checkpoints ------------------------------------------------------------------

CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ckpt_smoke")
# ckpt_parity: (layout, ring slots); sample-ahead calls of CKPT_K steps.
CKPT_CASES = (("double", 4096), ("double", 100_000), ("dedup", 4096))
CKPT_K = 64
# ckpt_train: config3's learner on a ring cut to this many slots.
CKPT_SLOTS = 262_144
CKPT_WARMUP = 4096


@contextlib.contextmanager
def float32_math():
    """float32 math, TF32 off, cuDNN's deterministic algorithms."""
    import torch

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def _ckpt_learner(layout: str, C: int):
    """A full-width fused learner (float32 compute, RMSProp, sample-ahead
    K = CKPT_K, B = 32) on the card, from the seed."""
    import torch

    from ape_x_dqn_tpu_torch.learner.train_step import init_train_state, make_optimizer
    from ape_x_dqn_tpu_torch.models.dueling import build_network
    from ape_x_dqn_tpu_torch.runtime.fused_dedup import FusedDedupLearner
    from ape_x_dqn_tpu_torch.runtime.fused_learner import FusedDeviceLearner

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        net = build_network("conv", 3, (84, 84, 1), compute_dtype=torch.float32)
    opt = make_optimizer("rmsprop")
    state = init_train_state(net, opt, seed=SEED, device="cuda")
    kw = dict(capacity=C, batch_size=32, steps_per_call=CKPT_K, ingest_block=1024,
              target_sync_freq=CKPT_K, sample_ahead=True, device="cuda")
    if layout == "dedup":
        return FusedDedupLearner(net, opt, state, (84, 84, 1), frame_ratio=1.25, **kw)
    return FusedDeviceLearner(net, opt, state, (84, 84, 1), **kw)


def _ckpt_feed(learner, layout: str, k: int, rows: int = 2000, ingest: bool = True):
    """Chunk ``k`` of a seeded stream (integer priorities 1..4); dedup
    chunks carry refs into the previous chunk from the second on."""
    from ape_x_dqn_tpu_torch.types import DedupChunk, NStepTransition

    r = np.random.default_rng(SEED + 1000 + k)
    prio = r.integers(1, 5, rows).astype(np.float32)
    cols = dict(action=r.integers(0, 3, rows).astype(np.int32),
                reward=r.normal(size=rows).astype(np.float32),
                discount=np.full(rows, 0.97, np.float32))
    if layout == "dedup":
        obs_ref = np.arange(rows, dtype=np.int32)
        if k:
            obs_ref[:2] = [-2, -1]
        learner.add_chunk(prio, DedupChunk(
            frames=r.integers(0, 256, (rows + 1, 84, 84, 1), dtype=np.uint8),
            obs_ref=obs_ref, next_ref=np.arange(1, rows + 1, dtype=np.int32),
            source=1, chunk_seq=k, prev_frames=rows + 1, **cols))
    else:
        learner.add_chunk(prio, NStepTransition(
            obs=r.integers(0, 256, (rows, 84, 84, 1), dtype=np.uint8),
            next_obs=r.integers(0, 256, (rows, 84, 84, 1), dtype=np.uint8), **cols))
    if ingest:
        learner.ingest_staged(drain=layout == "dedup")


def _ckpt_record(learner, sampling) -> dict:
    """Call 3 (staged rows drained first) and what it left, on the host."""
    import torch

    learner.ingest_staged(drain=True)
    before = sampling.sample_indices.launches
    learner.train(0.4)
    torch.cuda.synchronize()
    st, ring = learner.state, learner.replay
    tensors = {f"params.{k}": v for k, v in st.params.items()}
    tensors.update({f"target.{k}": v for k, v in st.target_params.items()})
    tensors.update({f"nu.{k}": v for k, v in st.opt_state["nu"].items()})
    tensors["ring.mass"] = ring.mass
    return {"indices": learner.graphed_call.body.sampled_indices().cpu(),
            "tensors": {k: v.detach().cpu() for k, v in tensors.items()},
            "counters": [learner.step, learner.size, ring.cursor, ring.count,
                         getattr(ring, "fcount", 0)],
            "launches": sampling.sample_indices.launches - before,
            "captures": learner.graphed_call.captures}


def ckpt_child(root: str) -> int:
    """``chip_smoke.py --ckpt-child ROOT``: a fresh process (no tensor and
    no graph of the parent) builds each case's learner, restores it in
    place from ``ROOT/<case>`` and runs call 3; the records go to
    ``ROOT/child.pt``."""
    import torch

    from ape_x_dqn_tpu_torch.ops import sampling
    from ape_x_dqn_tpu_torch.utils.checkpoint import load_replay_leg, restore_checkpoint

    out = {}
    with float32_math():
        for layout, C in CKPT_CASES:
            case = os.path.join(root, f"{layout}_{C}")
            learner = _ckpt_learner(layout, C)
            captured = learner.graphed_call.captures
            t0 = time.perf_counter()
            restore_checkpoint(case, learner.state, generator=learner.generator)
            leg = load_replay_leg(case, learner)
            torch.cuda.synchronize()
            rec = _ckpt_record(learner, sampling)
            rec.update(leg=leg, captured_at_build=captured,
                       restore_s=time.perf_counter() - t0)
            out[f"{layout}_{C}"] = rec
            del learner
            gc.collect()
            torch.cuda.empty_cache()
    torch.save(out, os.path.join(root, "child.pt"))
    return 0


def phase_ckpt_parity(sampling):
    """Resume in a fresh process equals the uninterrupted learner, bit for
    bit: two fused calls, a save (the npz leg for the double-store ring;
    an APXC base after call 1 and a delta after call 2 for the dedup ring,
    with a chunk still staged), call 3 as the reference; then a spawned
    ``chip_smoke.py --ckpt-child`` restores and runs call 3."""
    import shutil

    import torch

    from ape_x_dqn_tpu_torch.utils.checkpoint import save_checkpoint
    from ape_x_dqn_tpu_torch.utils.checkpoint_inc import IncrementalCheckpointer

    t0 = time.monotonic()
    root = os.path.join(CKPT_ROOT, "parity")
    shutil.rmtree(root, ignore_errors=True)
    refs, saves = {}, {}
    with float32_math():
        for layout, C in CKPT_CASES:
            name = f"{layout}_{C}"
            case = os.path.join(root, name)
            a = _ckpt_learner(layout, C)
            ck = IncrementalCheckpointer(case, a) if layout == "dedup" else None
            launches = sampling.sample_indices.launches
            _ckpt_feed(a, layout, 0)
            a.train(0.4)
            stalls = []
            if ck is not None:
                s0 = time.perf_counter()
                if not ck.save(a.step):
                    raise AssertionError("ckpt_parity: the base save was refused")
                stalls.append((time.perf_counter() - s0) * 1e3)
                ck.flush(600.0)
            _ckpt_feed(a, layout, 1)
            a.train(0.4)
            _ckpt_feed(a, layout, 2, rows=600, ingest=False)   # rides the save staged
            s0 = time.perf_counter()
            if ck is not None:
                if not ck.save(a.step):
                    raise AssertionError("ckpt_parity: the delta save was refused")
                save_checkpoint(case, a.state, generator=a.generator)
            else:
                save_checkpoint(case, a.state, replay=a, generator=a.generator)
            stalls.append((time.perf_counter() - s0) * 1e3)
            if ck is not None:
                ck.close()
                if ck.stats()["deltas"] != 1 or ck.stats()["bases"] != 1:
                    raise AssertionError(f"ckpt_parity: chain {ck.stats()}")
            refs[name] = _ckpt_record(a, sampling)
            refs[name]["parent_launches"] = sampling.sample_indices.launches - launches
            sizes = {f: os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(case)
                     for f in fs}
            saves[name] = {"stall_ms": stalls, "files": sizes}
            del a, ck
            gc.collect()
            torch.cuda.empty_cache()
    t1 = time.monotonic()
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--ckpt-child", root],
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise AssertionError(f"ckpt_parity child failed ({res.returncode}): "
                             f"{res.stderr[-3000:]}")
    child = torch.load(os.path.join(root, "child.pt"))
    cases, child_launches = [], 0
    for name, ref in refs.items():
        got = child[name]
        diff = {k: float((t.double() - got["tensors"][k].double()).abs().max())
                for k, t in ref["tensors"].items() if not torch.equal(t, got["tensors"][k])}
        case = {"case": name, "leg": got["leg"], "counters": got["counters"],
                "index_mismatches": int((ref["indices"] != got["indices"]).sum()),
                "unequal_tensors": diff, "child_captures": got["captures"],
                "child_launches": got["launches"], "parent_launches": ref["parent_launches"],
                "restore_s": got["restore_s"], "saves": saves[name]}
        cases.append(case)
        want_leg = "incremental" if name.startswith("dedup") else "snapshot"
        if case["index_mismatches"] or diff or got["counters"] != ref["counters"] \
                or got["captures"] != 1 or got["captured_at_build"] != 1 \
                or got["launches"] != 1 or ref["parent_launches"] != 3 \
                or got["leg"] != want_leg:
            emit({"phase": "ckpt_parity", "failed_case": case,
                  "reference_counters": ref["counters"]})
            raise AssertionError(f"ckpt_parity {name}: the resumed call differs from the "
                                 "uninterrupted one")
        child_launches += got["launches"]
    shutil.rmtree(root, ignore_errors=True)
    result = {"phase": "ckpt_parity", "K": CKPT_K, "B": 32, "cases": cases,
              "math": "float32, TF32 off, cudnn.deterministic",
              "checks": "indices, params, nu, target, mass, step/size/cursor/count/fcount "
                        "bit-identical; 1 capture in the child (none after the restore); "
                        "1 sampler launch per resumed call",
              "sampler_launches": child_launches, "child_s": time.monotonic() - t1,
              "seconds": time.monotonic() - t0}
    emit(result)
    return result


def _jsonl(path: str) -> list:
    """The records of a JSONL file; a line cut by a kill is skipped."""
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
    return out


def _shm_segments() -> set:
    return {n for n in os.listdir("/dev/shm") if n.startswith("apx")}


@contextlib.contextmanager
def observe_resume():
    """Time the resume's two halves (the state leg in ``build_components``,
    the ring once the fused learner exists) and record the learner's
    counters when ``run`` starts, before it trains."""
    from ape_x_dqn_tpu_torch.runtime import components
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline

    seen = {"restore_s": 0.0}
    restore, ring, run = components._restore, AsyncPipeline._restore_ring, AsyncPipeline.run

    def timed(fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seen["restore_s"] += time.perf_counter() - t0
        return wrapper

    def observed(self, *args, **kwargs):
        f = self.fused
        seen.update(pipe=self, step=self.learner_step, size=f.size,
                    shipped=f.stager.shipped_f, fcount=f.replay.fcount)
        return run(self, *args, **kwargs)

    components._restore, AsyncPipeline._restore_ring = timed(restore), timed(ring)
    AsyncPipeline.run = observed
    try:
        yield seen
    finally:
        components._restore, AsyncPipeline._restore_ring = restore, ring
        AsyncPipeline.run = run


def _ckpt_train_argv(root: str, steps: int, overlap: bool) -> list:
    K = DEDUP_K
    argv = ["--device", "cuda", "--steps", str(steps), "--log-every", str(K),
            "--set", "network=conv", "--set", "env.name=catch:84", "--set", f"seed={SEED}",
            "--set", f"replay.capacity={CKPT_SLOTS}", "--set", "replay.dedup=true",
            "--set", "replay.frame_ratio=1.25",
            "--set", "learner.device_replay=true", "--set", "learner.sample_ahead=true",
            "--set", f"learner.steps_per_call={K}", "--set", f"learner.ingest_block={K}",
            "--set", "learner.second_moment_dtype=bfloat16",
            "--set", "learner.target_dtype=bfloat16",
            "--set", "learner.q_target_sync_freq=2500", "--set", "learner.publish_every=2500",
            "--set", f"learner.min_replay_mem_size={CKPT_WARMUP}",
            "--set", "actor.mode=thread", "--set", "actor.num_actors=8",
            "--set", "actor.flush_every=16", "--set", "actor.T=1000000",
            "--set", f"learner.checkpoint_every={K}", "--set", f"learner.checkpoint_dir={root}",
            "--set", "learner.checkpoint_incremental=true"]
    if overlap:
        argv += ["--set", "learner.pipeline_depth=2", "--set", f"learner.sync_every={K}"]
    return argv


def phase_ckpt_train(sampling, card: str):
    """``train.main`` with config3's learner (ring cut to CKPT_SLOTS, thread
    actors) and incremental checkpoints every K steps, as a child process
    SIGKILLed after its second committed manifest; then ``train.main`` again
    with ``restore_from=true`` and the overlapped pipeline: it resumes at
    the committed step with the chain's counts and trains one more call,
    whose save continues the chain."""
    import shutil
    import signal

    import torch

    from ape_x_dqn_tpu_torch.utils.checkpoint import latest_step
    from ape_x_dqn_tpu_torch.utils.checkpoint_inc import inc_dir, read_manifest

    t0 = time.monotonic()
    K = DEDUP_K
    root = os.path.join(CKPT_ROOT, "train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    shm_before = _shm_segments()
    metrics = os.path.join(root, "killed.jsonl")
    stderr = open(os.path.join(root, "killed.stderr"), "w")
    child = subprocess.Popen(
        [sys.executable, "-m", "ape_x_dqn_tpu_torch.train", "--metrics-file", metrics,
         *_ckpt_train_argv(root, 200 * K, overlap=False)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.DEVNULL, stderr=stderr)
    try:
        deadline = time.monotonic() + 400
        while True:
            m = read_manifest(inc_dir(root))
            if m is not None and len(m["chunks"]) >= 2:
                break
            if child.poll() is not None:
                with open(os.path.join(root, "killed.stderr")) as f:
                    tail = f.read()[-3000:]
                raise AssertionError(f"ckpt_train: the trainer exited ({child.returncode}) "
                                     f"before two commits: {tail}")
            if time.monotonic() > deadline:
                raise AssertionError("ckpt_train: no second committed manifest in 400 s")
            time.sleep(0.05)
    finally:
        child.send_signal(signal.SIGKILL)
        child.wait(60)
        stderr.close()
    killed_s = time.monotonic() - t0
    manifest = read_manifest(inc_dir(root))
    committed = latest_step(root)
    # Each record after a save holds its stall; the first accepted save is
    # the base (no manifest yet), the later ones deltas or refused (the
    # writer still busy: ``inflight_skips``).
    saves = [{"step": r["step"], "stall_ms": r["ckpt/learner_stall_ms"],
              "saves": r["ckpt"]["saves"], "inflight_skips": r["ckpt"]["inflight_skips"]}
             for r in _jsonl(metrics) if "ckpt/learner_stall_ms" in r]
    chunk_bytes = {n: os.path.getsize(os.path.join(inc_dir(root), n))
                   for n in manifest["chunks"]}
    # The resume: the overlapped pipeline this time.
    gc.collect()
    torch.cuda.empty_cache()
    sampling.sample_indices.launches = 0
    resumed_metrics = os.path.join(root, "resumed.jsonl")
    with observe_resume() as seen:
        final, wall = run_train(_ckpt_train_argv(root, committed + K, overlap=True)
                                + ["--set", "learner.restore_from=true",
                                   "--metrics-file", resumed_metrics])
    resumed_stall = [r["ckpt/learner_stall_ms"] for r in _jsonl(resumed_metrics)
                     if "ckpt/learner_stall_ms" in r]
    launches = sampling.sample_indices.launches
    pipe = seen["pipe"]
    fused = pipe.fused
    mark = manifest["chain_mark"]
    after = read_manifest(inc_dir(root))
    Q = fused.replay.seq_modulus
    if seen["step"] != committed or seen["size"] != min(mark[0], CKPT_SLOTS) \
            or seen["shipped"] != mark[1] or seen["fcount"] != mark[1] % Q:
        raise AssertionError(f"ckpt_train: resumed at step {seen['step']} (committed "
                             f"{committed}), ring size {seen['size']}, frames shipped "
                             f"{seen['shipped']} (fcount {seen['fcount']}); chain mark {mark}")
    if final["step"] != committed + K or launches != 1:
        raise AssertionError(f"ckpt_train: resumed run ended at {final['step']} with "
                             f"{launches} sampler launches, want {committed + K} and 1")
    if after["generation"] != manifest["generation"] or \
            len(after["chunks"]) != len(manifest["chunks"]) + 1 or latest_step(root) != final["step"]:
        raise AssertionError(f"ckpt_train: the resumed save did not continue the chain: "
                             f"{manifest} -> {after}, latest step {latest_step(root)}")
    leftover = _shm_segments() - shm_before
    if leftover:
        raise AssertionError(f"ckpt_train: segments left in /dev/shm: {sorted(leftover)}")
    result = {
        "phase": "ckpt_train", "card": card, "capacity": CKPT_SLOTS,
        "frame_capacity": fused.replay.frame_capacity, "K": K,
        "killed_after_s": killed_s, "committed_step": committed,
        "chain": {"generation": manifest["generation"], "chunks": manifest["chunks"],
                  "chain_mark": mark, "chunk_bytes": chunk_bytes},
        "saves_before_kill": saves,
        "resumed": {"step": seen["step"], "ring_size": seen["size"],
                    "frames_shipped": seen["shipped"], "restore_s": seen["restore_s"],
                    "final_step": final["step"], "sampler_launches": launches,
                    "save_stall_ms": resumed_stall,
                    "ckpt": final.get("ckpt"), "pipeline": final.get("pipeline"),
                    "delta_bytes": os.path.getsize(os.path.join(inc_dir(root),
                                                                after["chunks"][-1])),
                    "wall_s": wall, "loss": final["learner/loss"]},
        "cuts": {"capacity": f"{CKPT_SLOTS} for 2000000 (a base of the 2M ring is 17.64 GB "
                             "on disk: profile_checkpoint measures that)",
                 "actors": "8 thread actors for 256", "env": "catch:84 for Seaquest",
                 "min_replay_mem_size": f"{CKPT_WARMUP} for 50000"},
        "sampler_launches": launches, "seconds": time.monotonic() - t0,
    }
    state = pipe.comps.state
    del seen, pipe, fused
    emit(result)
    return result, root, state


def phase_serve_checkpoint(card: str, root: str, state, duration: float = SERVE_DURATION_S):
    """``serve.main(["--checkpoint", root, "--listen", "0", "--clients", "4",
    ...])`` on the card over ``ckpt_train``'s directory; mid-run a newer step
    commits (``save_checkpoint``): the server reloads it, the replies carry
    its version, and a probe's q equals the CPU forward of that step's
    params within 1e-4 of the largest |q| (the served network computes in
    float32 here, TF32 off, as in ``serve_parity``); 0 client errors."""
    import torch

    from ape_x_dqn_tpu_torch import serve
    from ape_x_dqn_tpu_torch.config import load_config
    from ape_x_dqn_tpu_torch.runtime import components
    from ape_x_dqn_tpu_torch.serving.net_server import ServingClient
    from ape_x_dqn_tpu_torch.types import TrainState
    from ape_x_dqn_tpu_torch.utils.checkpoint import latest_step, save_checkpoint

    t0 = time.monotonic()
    argv = ["--checkpoint", root, "--listen", "0", "--clients", "4",
            "--duration", str(duration), "--metrics-every", "5", "--device", "cuda",
            "--set", "serving.reload_poll_s=0.25", "--set", "network=conv",
            "--set", "env.name=catch:84", "--set", f"seed={SEED}"]
    seeded = components.seeded_network

    def float32_network(*args, **kwargs):
        net = seeded(*args, **kwargs)
        net.compute_dtype = torch.float32
        return net

    out, rc, errors = io.StringIO(), [], []

    def serve_thread():
        try:
            rc.append(serve.main(argv))
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    v0 = latest_step(root)
    components.seeded_network = float32_network
    thread = threading.Thread(target=serve_thread, daemon=True)
    try:
        with float32_math(), contextlib.redirect_stdout(out):
            thread.start()
            deadline = time.monotonic() + 120
            port = None
            while port is None:
                for line in out.getvalue().splitlines():
                    if '"serving_listen"' in line:
                        port = json.loads(line)["port"]
                if errors or time.monotonic() > deadline:
                    raise AssertionError(f"serve_checkpoint: no serving_listen ({errors})")
                time.sleep(0.1)
            client = ServingClient("127.0.0.1", port)
            obs = np.random.default_rng(SEED).integers(0, 256, (84, 84, 1), dtype=np.uint8)
            first = client.act(obs)
            params = {k: v.detach().clone() for k, v in state.params.items()}
            with torch.no_grad():
                for v in params.values():
                    v.mul_(1.01)
            newer = TrainState(params=params, target_params=state.target_params,
                               opt_state=state.opt_state, step=v0 + 1, seed=state.seed)
            save_checkpoint(root, newer)
            committed_at = time.monotonic()
            while True:
                reply = client.act(obs)
                if reply.param_version == v0 + 1:
                    break
                if time.monotonic() - committed_at > 30:
                    raise AssertionError("serve_checkpoint: the newer step was not served")
            reload_s = time.monotonic() - committed_at
            net = float32_network(load_config(None, [
                "network=conv", "env.name=catch:84", f"seed={SEED}"]), 3, (84, 84, 1))
            with torch.no_grad():
                want = net.apply_params({k: v.cpu() for k, v in params.items()},
                                        torch.from_numpy(obs[None])).q[0].numpy()
            q_err = float(np.abs(reply.q_values - want).max() / np.abs(want).max())
            client.close()
            thread.join(duration + 120)
    finally:
        components.seeded_network = seeded
    if errors:
        raise AssertionError("serve_checkpoint: serve.main raised") from errors[0]
    recs = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    final = [r for r in recs if "serve/served_total" in r][-1]
    if rc != [0] or not final.get("final") or final["serve/reloads"] < 1 \
            or final["serve/param_version"] != v0 + 1 or first.param_version != v0 \
            or q_err > 1e-4:
        raise AssertionError(f"serve_checkpoint: rc {rc}, first version "
                             f"{first.param_version} (want {v0}), q error {q_err:.3g}, "
                             f"final {final}")
    result = {"phase": "serve_checkpoint", "card": card, "duration_s": duration,
              "cuts": {"duration_s": f"{duration} for 20.0 (smoke time)"},
              "versions": [v0, v0 + 1], "reload_after_commit_s": reload_s,
              "q_err_rel": q_err, "served_total": final["serve/served_total"],
              "qps": final["serve/served_total"] / duration, "qps_30s": final["serve/qps"],
              "latency_ms": {k: final.get(f"serve/{k}_ms") for k in ("p50", "p95", "p99")},
              "reloads": final["serve/reloads"], "batch_hist": final["serve/batch_hist"],
              "shed": final["serve/shed_total"], "client_errors": 0,
              "seconds": time.monotonic() - t0}
    emit(result)
    return result


REPO_DIR = os.path.dirname(os.path.abspath(__file__))
JOIN_ROOT = os.path.join(REPO_DIR, "build", "remote_join_smoke")
REMOTE_MAX_CALLS = 40


class RemoteJoinController:
    """Drives ``remote_join`` beside the running learner: once the pool has
    written its join spec, a ``python -m ape_x_dqn_tpu_torch.host_join``
    process claims the remote slot; after the slot delivered chunks its
    child is SIGKILLed, and it must be respawned (same attempt) and feed
    again; then ``pool.grow(1)`` starts the reserved local wid, which must
    feed, and ``pool.retire()`` drains it out through "done"; then, past
    ``min_steps``, the learner is stopped after the call in progress.  Any
    step that misses its deadline stops the run and is the phase's
    error."""

    def __init__(self, seen: list, join_path: str, min_steps: int, step_s: float = 90.0):
        self.seen, self.join_path, self.min_steps = seen, join_path, min_steps
        self.step_s = step_s
        self.events: list = []      # host_join's JSONL lines
        self.log: dict = {}
        self.error = None
        self.proc = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(30)
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.log["host_join_rc"] = self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.log["host_join_rc"] = self.proc.wait(timeout=10)
        elif self.proc is not None:
            self.log["host_join_rc"] = self.proc.returncode
        return False

    def _wait(self, cond, what: str):
        deadline = time.monotonic() + self.step_s
        while not cond():
            if self._stop.is_set():
                raise RuntimeError(f"stopped before: {what}")
            if time.monotonic() > deadline:
                raise TimeoutError(what)
            time.sleep(0.05)

    def _spawns(self) -> list:
        return [e for e in list(self.events) if e.get("event") == "host_join_spawn"]

    def _read(self):
        for line in self.proc.stdout:
            if line.startswith("{"):
                try:
                    self.events.append(json.loads(line))
                except ValueError:
                    pass

    def _run(self):
        pipe = None
        try:
            self._wait(lambda: bool(self.seen) and getattr(self.seen[0], "worker", None)
                       is not None and os.path.exists(self.join_path), "the join spec")
            pipe = self.seen[0]
            pool = pipe.worker.pool
            remote = pool.local_capacity     # the one remote wid
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "ape_x_dqn_tpu_torch.host_join", "--join",
                 self.join_path, "--host", "127.0.0.1"],
                cwd=REPO_DIR, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            threading.Thread(target=self._read, daemon=True).start()
            t0 = time.monotonic()
            self._wait(lambda: pool.chunks_by_worker.get(remote, 0) >= 2,
                       "the remote slot's first chunks")
            self.log["remote_first_chunks_s"] = time.monotonic() - t0
            victim = self._spawns()[0]["pid"]
            before = pool.chunks_by_worker[remote]
            os.kill(victim, signal.SIGKILL)
            t_kill = time.monotonic()
            self.log.update(killed_pid=victim, remote_chunks_at_kill=before)
            self._wait(lambda: len(self._spawns()) >= 2
                       and pool.chunks_by_worker.get(remote, 0) > before + 2,
                       "the respawned remote child feeding again")
            self.log["respawn_to_chunks_s"] = time.monotonic() - t_kill
            self.log["grown"] = pool.grow(1)
            if self.log["grown"] != [1]:
                raise AssertionError(f"grow(1) started {self.log['grown']}")
            t_grow = time.monotonic()
            self._wait(lambda: pool.chunks_by_worker.get(1, 0) >= 2,
                       "the grown worker's chunks")
            self.log["grow_to_chunks_s"] = time.monotonic() - t_grow
            self.log["retired"] = pool.retire()
            t_retire = time.monotonic()
            self._wait(lambda: 1 in pool.finished_workers and 1 not in pool._rings,
                       "the retired worker's clean exit")
            self.log["retire_to_reclaimed_s"] = time.monotonic() - t_retire
            self._wait(lambda: pipe._learner_step >= self.min_steps, "the learner's steps")
        except BaseException as e:  # noqa: BLE001 — the phase raises it
            self.error = e
        finally:
            if pipe is None and self.seen:
                pipe = self.seen[0]
            if pipe is not None:
                pipe.stop_event.set()


def phase_remote_join(sampling, card: str, beside: dict):
    """``train.main`` with config3's learner (``tcp_train``'s) fed by one
    local worker and one remote slot (``actor.remote_workers=1``), with
    ``actor.max_workers=2``: a separate ``host_join`` process claims the
    slot from the join spec, its child is SIGKILLed and respawned on the
    same attempt, and the pool grows a worker and retires it, all while the
    learner trains (``RemoteJoinController``).  Checks: the learner passes
    2 fused calls and every call launched the sampler once, the remote
    slot's chunks resumed after the kill (its connection counted as a
    reconnect, a torn tail counted, never decoded), the grown worker's
    chunks ingested and its retirement clean (reported "retired", no
    error, no restart), no CUDA in any local worker, no /dev/shm segment
    left, ``host_join`` exits 0."""
    import shutil

    import torch

    K = DEDUP_K
    shutil.rmtree(JOIN_ROOT, ignore_errors=True)
    os.makedirs(JOIN_ROOT)
    join_path = os.path.join(JOIN_ROOT, "join.json")
    argv = config3_argv(REMOTE_MAX_CALLS * K, workers=1) + TCP_ARGS + [
        "--set", "actor.remote_workers=1", "--set", f"actor.remote_join_path={join_path}",
        "--set", "actor.max_workers=2"]
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shm_before = _shm_segments()
    sampling.sample_indices.launches = 0
    with capture_pipelines() as seen, compute_apps() as apps, \
            timed_fused_calls() as spans, \
            RemoteJoinController(seen, join_path, min_steps=2 * K) as ctl:
        final, wall = run_train(argv)
    launches = sampling.sample_indices.launches
    shutil.rmtree(JOIN_ROOT, ignore_errors=True)
    if ctl.error is not None:
        raise AssertionError(f"remote_join: {ctl.error!r}; log {ctl.log}; "
                             f"host_join {ctl.events[-6:]}") from ctl.error
    pipe = seen[0]
    pool, fused = pipe.worker.pool, pipe.fused
    calls = len(spans)
    if final["step"] < 2 * K or launches != calls or final["step"] != calls * K:
        raise AssertionError(f"remote_join: {final['step']} steps, {calls} calls, "
                             f"{launches} sampler launches")
    reports, pids = check_workers("remote_join", pool, apps)
    if not reports[1].get("retired") or 1 not in pool.retired or pool.retires != 1 \
            or pool.grows != 1:
        raise AssertionError(f"remote_join: grow/retire {pool.grows}/{pool.retires}, "
                             f"reports {reports}")
    net, xp = final["net"], final["xp_transport"]
    respawns = [e for e in ctl.events if e.get("event") == "host_join_respawn"]
    if not respawns or net["reconnects"] < 1 or net["rejects"] \
            or ctl.log.get("host_join_rc") != 0:
        raise AssertionError(f"remote_join: host_join {ctl.events}, net {net}, "
                             f"log {ctl.log}")
    if _shm_segments() - shm_before:
        raise AssertionError(f"remote_join: /dev/shm left {_shm_segments() - shm_before}")
    call_ms = [s.elapsed_time(e) for s, e, *_ in spans]
    remote = pool.local_capacity
    result = {
        "phase": "remote_join", "card": card, "learner_steps": final["step"],
        "fused_calls": calls, "sampler_launches": launches,
        "learner_steps_per_s": final["step"] / final["train_s"], "train_s": final["train_s"],
        "learner_steps_per_s_second_call": K / (call_ms[1] / 1e3),
        "fused_call_ms": call_ms, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "actor_fps": final["actor_fps"], "actor_steps": final["actor_steps"],
        "chunks_by_worker": dict(pool.chunks_by_worker), "remote_wid": remote,
        "controller": ctl.log, "host_join_events": [
            {k: e[k] for k in ("event", "wid") if k in e} for e in ctl.events],
        "net": {k: net[k] for k in ("connections", "expected", "bytes_in", "frames_in",
                                    "wire_over_logical", "records_per_frame", "torn_frames",
                                    "reconnects", "rejects", "param_pushes", "param_full",
                                    "param_delta")},
        "xp_transport": {k: xp[k] for k in ("chunks", "transitions", "salvaged_records",
                                            "torn_records", "chunk_latency_ms")},
        "workers": {w: {"threads": r["threads"], "cuda_initialized": r["cuda_initialized"],
                        "retired": r["retired"], "param_source": r["param_source"]}
                    for w, r in sorted(reports.items())},
        "smi_compute_pids": sorted(pids), "staged_rows_left": fused.staged_rows,
        "cuts": {"env": "catch:84 for SeaquestNoFrameskip-v4",
                 "actors": "1 local worker + 1 remote slot (+1 grown, then retired) "
                           "x 16 actors in all for 8 x 32",
                 "hosts": "the remote slot joins over loopback (one host on the machine)",
                 "min_replay_mem_size": f"{DEDUP_WARMUP} for 50000",
                 "data_parallel": "1 for 4"},
        "wall_s": wall, "seconds": time.monotonic() - t0,
        f"beside_{beside['phase']}": {k: beside[k] for k in (
            "learner_steps_per_s", "learner_steps_per_s_second_call", "peak_mem_bytes")},
    }
    emit(result)
    return result


SERVE_HUB_ARGS = ["--set", "network=conv", "--set", "env.name=catch:84",
                  "--set", f"seed={SEED}", "--set", "replay.capacity=1024",
                  "--set", "learner.min_replay_mem_size=32",
                  "--set", "serving.reload_poll_s=0.05"]


def float32_serving(argv) -> int:
    """``serve.main(argv)`` with the served network computing in float32
    and TF32 off (the q checks' reference is a float32 forward)."""
    import torch

    from ape_x_dqn_tpu_torch import serve
    from ape_x_dqn_tpu_torch.runtime import components

    seeded = components.seeded_network

    def float32_network(*args, **kwargs):
        net = seeded(*args, **kwargs)
        net.compute_dtype = torch.float32
        return net

    components.seeded_network = float32_network
    try:
        with float32_math():
            return serve.main(argv)
    finally:
        components.seeded_network = seeded


def serve_child(argv) -> int:
    """``chip_smoke.py --serve-child ARGS``: one serve process (float32)."""
    return float32_serving(argv)


def _listen_port(out_lines, what: str, deadline_s: float = 180.0) -> int:
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        for line in list(out_lines()):
            if '"serving_listen"' in line:
                return json.loads(line)["port"]
        time.sleep(0.1)
    raise AssertionError(f"serve_hub: {what} never listened")


def _probe_until(client, obs, version: int, timeout_s: float = 60.0):
    """A reply served at ``version`` (or later), retried while shed."""
    from ape_x_dqn_tpu_torch.serving.batcher import ServerOverloaded

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            reply = client.act(obs, timeout=30.0)
        except ServerOverloaded:
            time.sleep(0.05)
            continue
        if reply.param_version >= version:
            return reply
        time.sleep(0.02)
    raise AssertionError(f"serve_hub: version {version} never served")


def phase_serve_hub(card: str, trained: dict, duration: float = SERVE_HUB_DURATION_S):
    """The param hub and the param tail on the card.  A ``NetTransport`` in
    this process is the hub: it publishes ``tcp_train``'s trained params
    (version 1, full) and a newer version that changes one head's bias
    (version 2, a page delta).  A ``serve --param-hub --listen 0 --clients
    4`` process (``chip_smoke.py --serve-child``, float32) serves them: the
    q of a probe at each version within 1e-4 (of the largest |q|) of a
    float32 forward of that version's params, rc 0.  Then ``serve.main``
    here, on a second hub channel with ``serving.param_stale_s=2``: after
    publishing pauses, requests shed with ``E_OVERLOADED``; version 3
    recovers it.  Then ``serve --param-tail`` over a ``ParamTailWriter``
    chain of the same versions (a full, then a delta) serves them with the
    same q."""
    import shutil

    import torch

    from ape_x_dqn_tpu_torch.config import load_config
    from ape_x_dqn_tpu_torch.runtime import components
    from ape_x_dqn_tpu_torch.runtime.net import NetTransport
    from ape_x_dqn_tpu_torch.serving.batcher import ServerOverloaded
    from ape_x_dqn_tpu_torch.serving.net_server import ServingClient
    from ape_x_dqn_tpu_torch.serving.sources import ParamTailWriter
    from ape_x_dqn_tpu_torch.utils.serialization import tree_to_bytes

    t0 = time.monotonic()
    v1 = {k: v.clone() for k, v in trained["_params"].items()}
    v2 = {k: v.clone() for k, v in v1.items()}
    head = sorted(k for k in v2 if k.endswith("bias"))[-1]
    v2[head] += 0.25
    v3 = {k: v.clone() for k, v in v2.items()}
    v3[head] -= 0.5
    versions = {1: v1, 2: v2, 3: v3}
    net = components.seeded_network(load_config(None, [
        "network=conv", "env.name=catch:84", f"seed={SEED}"]), 3, (84, 84, 1))
    net.compute_dtype = torch.float32
    obs = np.random.default_rng(SEED + 5).integers(0, 256, (84, 84, 1), dtype=np.uint8)
    with torch.no_grad():
        want = {v: net.apply_params(p, torch.from_numpy(obs[None])).q[0].numpy()
                for v, p in versions.items()}

    def q_err(reply):
        w = want[reply.param_version]
        return float(np.abs(reply.q_values - w).max() / np.abs(w).max())

    result = {"phase": "serve_hub", "card": card, "changed_leaf": head,
              "cuts": {"duration_s": f"{duration} for 8.0 (smoke time)"}}
    hub = NetTransport(port=0)
    for wid in (0, 1):
        hub.make_channel(wid, 0)
    stop_pump = threading.Event()

    def pump():
        while not stop_pump.wait(0.01):
            hub.pump()

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    tail_root = os.path.join(REPO_DIR, "build", "param_tail_smoke")
    try:
        pushes = [hub.set_params(tree_to_bytes(v1), 1)]
        # The hub replica: a separate serve process.
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-child", "--param-hub",
             f"127.0.0.1:{hub.port}:{hub.token}:0:0", "--listen", "0", "--clients", "4",
             "--duration", str(duration), "--metrics-every", "1", "--device", "cuda",
             *SERVE_HUB_ARGS],
            cwd=REPO_DIR, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        lines: list = []
        threading.Thread(target=lambda: lines.extend(child.stdout), daemon=True).start()
        port = _listen_port(lambda: lines, "the hub replica")
        client = ServingClient("127.0.0.1", port)
        r1 = _probe_until(client, obs, 1)
        pushes.append(hub.set_params(tree_to_bytes(v2), 2))
        r2 = _probe_until(client, obs, 2)
        client.close()
        rc = child.wait(timeout=duration + 120)
        recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
        final = [r for r in recs if r.get("final")][-1]
        errs = {1: q_err(r1), 2: q_err(r2)}
        if rc != 0 or pushes[1]["delta"] != 1 or max(errs.values()) > 1e-4 \
                or final["serve/param_version"] != 2 or final["serve/served_total"] <= 0:
            raise AssertionError(f"serve_hub: rc {rc}, pushes {pushes}, q errors {errs}, "
                                 f"final {final}")
        result["hub_replica"] = {
            "q_err_rel": errs, "pushes": pushes, "snapshot_bytes": len(tree_to_bytes(v1)),
            "served_total": final["serve/served_total"],
            "qps": final["serve/served_total"] / duration,
            "latency_ms": {k: final.get(f"serve/{k}_ms") for k in ("p50", "p99")},
            "reloads": final["serve/reloads"]}

        # Staleness: serve.main here on the hub's second channel, no clients
        # of its own; this process's client probes.
        out, rcs, errors = io.StringIO(), [], []
        stale_argv = ["--param-hub", f"127.0.0.1:{hub.port}:{hub.token}:1:0",
                      "--listen", "0", "--duration", str(duration),
                      "--metrics-every", "0.1", "--device", "cuda", *SERVE_HUB_ARGS,
                      "--set", "serving.param_stale_s=2"]

        def stale_thread():
            try:
                rcs.append(float32_serving(stale_argv))
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)

        with contextlib.redirect_stdout(out):
            th = threading.Thread(target=stale_thread, daemon=True)
            th.start()
            port = _listen_port(lambda: out.getvalue().splitlines(), "the stale-bound replica")
            client = ServingClient("127.0.0.1", port)
            fresh = _probe_until(client, obs, 2)
            shed, t_quiet = 0, time.monotonic()
            while not shed and time.monotonic() - t_quiet < 30:
                try:
                    client.act(obs, timeout=30.0)
                except ServerOverloaded:
                    shed += 1
                time.sleep(0.05)
            shed_after_s = time.monotonic() - t_quiet
            t_publish = time.monotonic()
            hub.set_params(tree_to_bytes(v3), 3)
            recovered = _probe_until(client, obs, 3)
            recover_s = time.monotonic() - t_publish
            client.close()
            th.join(duration + 120)
        events = [json.loads(ln).get("event") for ln in out.getvalue().splitlines()
                  if ln.startswith("{")]
        errs3 = q_err(recovered)
        if errors or rcs != [0] or not shed or "serving_degraded" not in events \
                or "serving_recovered" not in events or errs3 > 1e-4 \
                or fresh.param_version != 2:
            raise AssertionError(f"serve_hub staleness: rc {rcs} {errors}, shed {shed}, "
                                 f"events {events}, q error {errs3}")
        result["staleness"] = {"param_stale_s": 2, "shed_seen": client.shed_seen,
                               "shed_after_quiet_s": shed_after_s,
                               "served_after_publish_s": recover_s,
                               "recovered_version": recovered.param_version,
                               "q_err_rel": errs3}
        result["hub"] = {k: hub.stats()[k] for k in ("param_pushes", "param_full",
                                                     "param_delta", "param_bytes",
                                                     "reconnects", "rejects")}

        # The tail: v1 full, then v2 as a delta file.
        shutil.rmtree(tail_root, ignore_errors=True)
        tail = ParamTailWriter(tail_root, base_every=16)
        tail.publish(v1)
        out = io.StringIO()
        tail_argv = ["--param-tail", tail_root, "--listen", "0", "--clients", "4",
                     "--duration", str(duration), "--metrics-every", "1", "--device", "cuda",
                     *SERVE_HUB_ARGS]
        rcs, errors = [], []

        def tail_thread():
            try:
                rcs.append(float32_serving(tail_argv))
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)

        with contextlib.redirect_stdout(out):
            th = threading.Thread(target=tail_thread, daemon=True)
            th.start()
            port = _listen_port(lambda: out.getvalue().splitlines(), "the tail replica")
            client = ServingClient("127.0.0.1", port)
            t1 = _probe_until(client, obs, 1)
            tail.publish(v2)
            t2 = _probe_until(client, obs, 2)
            client.close()
            th.join(duration + 120)
        recs = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
        final = [r for r in recs if r.get("final")][-1]
        errs = {1: q_err(t1), 2: q_err(t2)}
        if errors or rcs != [0] or (tail.full_writes, tail.delta_writes) != (1, 1) \
                or max(errs.values()) > 1e-4 or final["serve/param_version"] != 2:
            raise AssertionError(f"serve_hub tail: rc {rcs} {errors}, writes "
                                 f"{tail.full_writes}/{tail.delta_writes}, q {errs}")
        result["tail_replica"] = {"q_err_rel": errs, "bytes_written": tail.bytes_written,
                                  "served_total": final["serve/served_total"],
                                  "qps": final["serve/served_total"] / duration,
                                  "latency_ms": {k: final.get(f"serve/{k}_ms")
                                                 for k in ("p50", "p99")}}
    finally:
        stop_pump.set()
        pumper.join(10)
        hub.close()
        shutil.rmtree(tail_root, ignore_errors=True)
    result["seconds"] = time.monotonic() - t0
    emit(result)
    return result


FLEET_ROOT = os.path.join(REPO_DIR, "build", "fleet_smoke")
FLEET_PROBE_S = 0.25          # the router's /healthz cadence in the fleet phases
# serve_fleet's q check: the replicas compute as ``serve`` builds their
# network, in bf16 (the default; the CLI has no float32 switch in either
# package), so a CPU forward at the same compute is the reference, held to
# the bf16 tolerance of the repo's tests (tests/test_torch_model.py).
FLEET_Q_RTOL = 2e-2


def counting_client(host: str, port: int, seed: int = 0):
    """A ``ServingClient`` whose torn or unknown reply frames are counted on
    ``torn`` (the client retires the connection and resends the request
    whole)."""
    from ape_x_dqn_tpu_torch.serving.net_server import ServingClient

    class CountingClient(ServingClient):
        torn = 0

        def _await_reply(self, rid, deadline):
            got = super()._await_reply(rid, deadline)
            if got is None:
                self.torn += 1
            return got

    return CountingClient(host, port, seed=seed)


def _jsonl_reader(proc, lines: list) -> threading.Thread:
    def read():
        for ln in proc.stdout:
            if ln.startswith("{"):
                try:
                    lines.append(json.loads(ln))
                except ValueError:
                    pass
    th = threading.Thread(target=read, daemon=True)
    th.start()
    return th


def _wait_for(cond, what: str, timeout: float, proc=None):
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{what}: the process exited rc {proc.returncode}")
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _varz(url: str) -> dict:
    status, body = _get(f"{url}/varz")
    if status != 200:
        raise AssertionError(f"{url}/varz answered {status}")
    return json.loads(body)


def card_contexts() -> int:
    """How many CUDA contexts the card holds: the rows of nvidia-smi's
    compute apps.  (Its pids are of the host's namespace: in a container
    every row can name the same pid, so the fleet phases count rows.)"""
    res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return sum(1 for ln in res.stdout.splitlines() if ln.strip())


def device_mappings(pid: int) -> int:
    """Mappings of the card's device files (``/dev/nvidia*``) in
    ``/proc/PID/maps``: reported beside ``card_contexts``."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return sum("/dev/nvidia" in ln for ln in f)
    except OSError:
        return -1


def phase_serve_fleet(card: str, root: str, state, clients: int = 4):
    """``python -m ape_x_dqn_tpu_torch.serve --replicas 2 --checkpoint
    ckpt_train's dir --listen 0 --obs-port 0`` as a child (its replicas,
    ``serve --param-hub``, on this card; ``state`` is the train state whose
    params the newest step holds).  ``clients`` closed-loop clients
    drive the router with single observations all through.  Checks: each
    replica's q (asked directly) equals a CPU forward of the checkpoint's
    params at the replicas' compute within ``FLEET_Q_RTOL`` of the largest
    |q|; a step committed mid-burst that changes the heads' biases reaches
    both replicas as a page delta (push bytes below a tenth of the
    snapshot) and their ``param_version`` advances to 2, with q to match;
    replica 0 SIGKILLed: the router drains it within one probe, no request
    is dropped (every ``act`` answered, retried across reconnects) and no
    frame torn (clients and replicas), the fleet respawns it, it full-syncs
    version 2 and takes routes again; the card holds one context more per
    replica while the fleet serves (nvidia-smi's rows, before the kill and
    after the respawn), none for the router's process; rc 0 after SIGTERM,
    every child reaped.  Reports QPS, the round trip p50/p99
    through the router, the push bytes, the kill's drain and respawn
    times."""
    import shutil

    import torch

    from ape_x_dqn_tpu_torch.config import load_config
    from ape_x_dqn_tpu_torch.runtime.process_actors import network_and_template
    from ape_x_dqn_tpu_torch.serving.sources import CheckpointParamSource
    from ape_x_dqn_tpu_torch.types import TrainState
    from ape_x_dqn_tpu_torch.utils.checkpoint import latest_step, save_checkpoint
    from ape_x_dqn_tpu_torch.utils.metrics import LatencyHistogram
    from ape_x_dqn_tpu_torch.utils.serialization import tree_to_bytes

    t0 = time.monotonic()
    cfg_args = ["network=conv", "env.name=catch:84", f"seed={SEED}",
                "serving.reload_poll_s=0.25", f"serving.probe_interval_s={FLEET_PROBE_S}"]
    cfg = load_config(None, cfg_args)
    obs_shape, net, template = network_and_template(cfg)
    v0 = latest_step(root)
    params1, _ = CheckpointParamSource(root, template).get(-1)
    params2 = {k: v.clone() for k, v in params1.items()}
    heads = [k for k in params2 if k.endswith("bias") and k.startswith(("value", "advantage"))]
    for k in heads:
        params2[k] += 0.25
    snapshot_bytes = len(tree_to_bytes(params1))
    probe = np.random.default_rng(SEED + 11).integers(0, 256, (4, *obs_shape), dtype=np.uint8)

    def cpu_q(params, dtype):
        net.compute_dtype = dtype
        with torch.no_grad():
            return net.apply_params(params, torch.from_numpy(probe)).q.float().numpy()

    want = {1: cpu_q(params1, torch.bfloat16), 2: cpu_q(params2, torch.bfloat16)}
    want32 = {1: cpu_q(params1, torch.float32), 2: cpu_q(params2, torch.float32)}
    argv = [sys.executable, "-m", "ape_x_dqn_tpu_torch.serve", "--replicas", "2",
            "--checkpoint", root, "--listen", "0", "--obs-port", "0", "--duration", "0",
            "--metrics-every", "1", "--device", "cuda",
            *(a for ov in cfg_args for a in ("--set", ov))]
    os.makedirs(FLEET_ROOT, exist_ok=True)
    err_path = os.path.join(FLEET_ROOT, "serve_fleet.err")
    lines: list = []
    known_pids: set = set()
    stop = threading.Event()
    stats = {"requests": 0, "errors": [], "versions": set()}
    lat = LatencyHistogram()
    lock = threading.Lock()
    workers: list = []
    conns: list = []
    contexts = {"before": card_contexts()}
    with open(err_path, "w") as err:
        child = subprocess.Popen(argv, cwd=REPO_DIR, stdout=subprocess.PIPE, stderr=err,
                                 text=True)
        _jsonl_reader(child, lines)
        try:
            router = _wait_for(lambda: next((r for r in lines if r.get("event") == "serving_listen"
                                             and r.get("mode") == "router"), None),
                               "the router", 300, child)
            url = _wait_for(lambda: next((r["url"] for r in lines
                                          if r.get("event") == "obs_exporter"), None),
                            "the fleet's exporter", 60, child)
            t_up = time.monotonic()

            def fleet_varz():
                return _varz(url)

            def replicas():
                reps = fleet_varz()["serving_fleet"]["replicas"]
                known_pids.update(r["pid"] for r in reps.values() if r["pid"])
                return reps

            def client_loop(i):
                c = counting_client("127.0.0.1", router["port"], seed=i)
                conns.append(c)
                rng = np.random.default_rng(SEED + 100 + i)
                while not stop.is_set():
                    obs = rng.integers(0, 256, obs_shape, dtype=np.uint8)
                    try:
                        r = c.act(obs, timeout=60.0)
                    except Exception as e:  # noqa: BLE001 — a dropped request, gated below
                        with lock:
                            stats["errors"].append(f"{type(e).__name__}: {e}")
                        continue
                    with lock:
                        stats["requests"] += 1
                        stats["versions"].add(r.param_version)
                        lat.record(r.latency_s)

            def replica_q(version):
                """Each replica's q on the probe, asked on its own port, once
                it serves ``version``."""
                out = {}
                for rid, rep in replicas().items():
                    c = counting_client("127.0.0.1", rep["port"], seed=50 + int(rid))
                    deadline = time.monotonic() + 60
                    try:
                        while True:
                            got = [c.act(o, timeout=60.0) for o in probe]
                            if {r.param_version for r in got} == {version}:
                                break
                            if time.monotonic() > deadline:
                                raise AssertionError(f"serve_fleet: replica {rid} never "
                                                     f"served version {version}")
                            time.sleep(0.05)
                    finally:
                        c.close()
                    q = np.stack([r.q_values for r in got])
                    scale = float(np.abs(want[version]).max())
                    out[rid] = {"q_err_rel": float(np.abs(q - want[version]).max() / scale),
                                "q_err_rel_float32": float(
                                    np.abs(q - want32[version]).max() / scale)}
                return out

            q1 = replica_q(1)
            contexts["serving"] = card_contexts()
            workers = [threading.Thread(target=client_loop, args=(i,), daemon=True)
                       for i in range(clients)]
            for w in workers:
                w.start()
            time.sleep(3.0)
            # Mid-burst: a newer step that moves the heads' biases.
            save_checkpoint(root, TrainState(params=params2, target_params=state.target_params,
                                             opt_state=state.opt_state, step=v0 + 1,
                                             seed=state.seed))
            t_commit = time.monotonic()
            push = _wait_for(lambda: next((r for r in lines if r.get("event") == "fleet_param_push"
                                           and r.get("step") == v0 + 1), None),
                             "the push of the new step", 60, child)
            q2 = replica_q(2)
            push_s = time.monotonic() - t_commit
            time.sleep(3.0)
            # SIGKILL replica 0.
            reps = replicas()
            victim = reps["0"]["pid"]
            routed_before = fleet_varz()["serving_router"]["endpoints"]["0"]["routed_total"]
            drains_before = fleet_varz()["serving_router"]["probe_failures"]
            t_kill = time.monotonic()
            os.kill(victim, signal.SIGKILL)
            _wait_for(lambda: not fleet_varz()["serving_router"]["endpoints"]["0"]["healthy"],
                      "the router to drain replica 0", 30, child)
            drain_s = time.monotonic() - t_kill
            _wait_for(lambda: any(r.get("event") == "replica_respawned" for r in lines),
                      "replica 0's respawn", 300, child)
            respawn_s = time.monotonic() - t_kill
            _wait_for(lambda: fleet_varz()["serving_router"]["endpoints"]["0"]["healthy"],
                      "replica 0 back in rotation", 60, child)
            q_respawned = replica_q(2)
            contexts["respawned"] = card_contexts()
            # Fresh connections spread round robin: the respawned replica (a
            # new endpoint, its count from 0) takes routes.
            for i in range(4):
                c = counting_client("127.0.0.1", router["port"], seed=200 + i)
                conns.append(c)
                c.act(probe[0], timeout=60.0)
            routed_after = fleet_varz()["serving_router"]["endpoints"]["0"]["routed_total"]
            reps = replicas()
            mappings = {"replicas": {rid: device_mappings(r["pid"]) for rid, r in reps.items()},
                        "router": device_mappings(child.pid)}
            time.sleep(2.0)
            stop.set()
            for w in workers:
                w.join(120)
            t_end = time.monotonic()
            varz_by_rid = {rid: _varz(f"http://127.0.0.1:{r['obs_port']}") for rid, r in
                           reps.items()}
            fleet_final = fleet_varz()
        finally:
            stop.set()
            for c in conns:
                c.close()
            if child.poll() is None:
                child.send_signal(signal.SIGTERM)
            try:
                rc = child.wait(timeout=120)
            except subprocess.TimeoutExpired:
                child.kill()
                rc = child.wait(timeout=30)
            for pid in known_pids:   # a replica the fleet did not reap
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
    alive = [pid for pid in known_pids if os.path.exists(f"/proc/{pid}")
             and open(f"/proc/{pid}/stat").read().split()[2] != "Z"]
    pids_now = {r["pid"] for r in reps.values()}
    torn_clients = sum(c.torn for c in conns)
    torn_replicas = {rid: v["serving"]["net"]["torn_frames"] for rid, v in varz_by_rid.items()}
    errs = [max(v["q_err_rel"] for v in q.values()) for q in (q1, q2, q_respawned)]
    final = [r for r in lines if r.get("final")]
    fleet_st = fleet_final["serving_fleet"]
    checks = {
        "rc_0": rc == 0 and bool(final),
        "q_within_tolerance": max(errs) <= FLEET_Q_RTOL,
        "delta_to_both": (push["delta"], push["full"]) == (2, 0)
                         and push["bytes"] < snapshot_bytes // 10,
        "versions_advance": all(v["serving"]["param_version"] == 2
                                for v in varz_by_rid.values())
                            and fleet_st["param_version"] == 2,
        "drained_within_one_probe": drain_s <= FLEET_PROBE_S + 0.5,
        "no_request_dropped": not stats["errors"],
        "no_frame_torn": torn_clients == 0 and not any(torn_replicas.values()),
        "respawned_in_rotation": fleet_st["respawns"] == 1
                                 and fleet_st["replicas"]["0"]["attempt"] == 1
                                 and routed_after > 0,
        "a_context_per_replica": contexts["serving"] == contexts["respawned"]
                                 == contexts["before"] + 2,
        "children_reaped": not alive,
    }
    if not all(checks.values()):
        with open(err_path) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"serve_fleet: {checks}; q {q1} {q2} {q_respawned}; push {push}; "
                             f"drain {drain_s}; errors {stats['errors'][:5]}; torn "
                             f"{torn_clients} {torn_replicas}; contexts {contexts}; "
                             f"alive {alive}; stderr {tail}")
    shutil.rmtree(FLEET_ROOT, ignore_errors=True)
    burst_s = t_end - t_up
    summary = lat.summary()
    result = {
        "phase": "serve_fleet", "card": card, "replicas": 2, "clients": clients,
        "checkpoint_step": v0, "requests": stats["requests"],
        "qps": stats["requests"] / burst_s, "burst_s": burst_s,
        "rtt_ms": {k: summary.get(k) for k in ("p50_ms", "p99_ms", "count")},
        "q_err_rel": {"v1": q1, "v2": q2, "respawned": q_respawned},
        "q_tolerance": {"rel": FLEET_Q_RTOL, "compute": "bfloat16 (serve's default)"},
        "push": push, "snapshot_bytes": snapshot_bytes, "changed_leaves": heads,
        "commit_to_served_s": push_s, "kill_to_drained_s": drain_s,
        "kill_to_respawned_s": respawn_s, "probe_interval_s": FLEET_PROBE_S,
        "routed_to_replica0": {"before_kill": routed_before, "after_respawn": routed_after},
        "probe_failures_before_kill": drains_before,
        "retries": sum(c.retries for c in conns), "reconnects": sum(c.reconnects for c in conns),
        "versions_seen": sorted(stats["versions"]), "torn": {"clients": torn_clients,
                                                             "replicas": torn_replicas},
        "router": fleet_final["serving_router"],
        "fleet": {k: fleet_st[k] for k in ("param", "respawns", "param_version")},
        "replica_pids": sorted(pids_now), "killed_pid": victim, "router_pid": child.pid,
        "card_contexts": contexts, "device_mappings": mappings,
        "seconds": time.monotonic() - t0,
    }
    emit(result)
    return result


def phase_central_fleet(sampling, card: str, beside: dict, calls: int = 4):
    """This slice's main path: config3's learner (``dedup_train``'s cuts,
    ``calls`` fused calls) fed by 2 workers × 8 paramless central actors
    (``actor.inference=central``) that dial the router of a 2-replica
    ``ServingFleet`` on this card (``serve --param-hub`` children with the
    run's token); the learner's publishes are relayed to the fleet's hub
    (the replies then carry the fleet's versions).  Replica 0 is SIGKILLed
    once the learner has run its first call.  Checks: the learner reaches
    its step target, one sampler launch per fused call, 0 worker deaths, 0
    torn replies (workers) and 0 torn frames (the live replicas), every
    fleet step's actions from the replicas (no fallback), replies at a
    relayed version ≥ 3, the respawn observed (back in rotation, full-synced
    to the newest version), the card holding one context more per replica
    (nvidia-smi's rows) with the fleet up and after the respawn.
    Reports learner steps/s beside ``central_train``'s from the same run,
    the workers' round trips while the learner replays, the relay's
    pushes."""
    import secrets

    import torch

    from ape_x_dqn_tpu_torch.config import load_config
    from ape_x_dqn_tpu_torch.runtime.process_actors import network_and_template
    from ape_x_dqn_tpu_torch.serving.router import ServingFleet

    K = DEDUP_K
    steps = calls * K
    t0 = time.monotonic()
    token = secrets.randbits(63) or 1
    net_args = ["network=conv", "env.name=catch:84", f"seed={SEED}"]
    events: list = []
    fleet = ServingFleet(replicas=2, probe_interval_s=FLEET_PROBE_S,
                         replica_args=["--device", "cuda", "--run-token", str(token),
                                       *(a for ov in net_args for a in ("--set", ov))],
                         on_event=lambda kind, **f: events.append(
                             {"event": kind, "t": time.monotonic(), **f}))
    # The replicas serve the learner's initial params until its first
    # publish (the same config and seed build the same ones).
    fleet.publish(network_and_template(load_config(None, net_args))[2])
    relay = {"pushes": [], "have": -1, "error": None}
    stop_relay = threading.Event()
    kill = {}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sampling.sample_indices.launches = 0
    contexts = {"before": card_contexts()}
    try:
        fleet.start(timeout=300)
        t_fleet = time.monotonic() - t0
        contexts["fleet_up"] = card_contexts()
        argv = config3_argv(steps) + [
            "--set", "actor.inference=central", "--set", "actor.inference_host=127.0.0.1",
            "--set", f"actor.inference_port={fleet.port}",
            "--set", f"actor.inference_token={token}"]

        with capture_pipelines() as seen, timed_fused_calls() as spans, \
                rtt_after_warmup() as warm_rtt:
            def relay_loop():
                """The trainer's publishes → the fleet's hub; replica 0
                SIGKILLed after the first fused call."""
                try:
                    while not stop_relay.wait(0.1):
                        if not seen:
                            continue
                        pipe = seen[0]
                        got = pipe.store.get(relay["have"])
                        if got is not None:
                            params, relay["have"] = got
                            relay["pushes"].append(fleet.publish(params))
                        if not kill and spans:
                            kill["pid"] = fleet.replicas[0].pid
                            kill["t"] = time.monotonic()
                            kill["step"] = pipe.learner_step
                            fleet.replicas[0].kill()
                except BaseException as e:  # noqa: BLE001 — raised by the phase
                    relay["error"] = e

            relay_thread = threading.Thread(target=relay_loop, daemon=True)
            relay_thread.start()
            try:
                final, wall = run_train(argv)
            finally:
                stop_relay.set()
                relay_thread.join(60)
        launches = sampling.sample_indices.launches
        torch.cuda.synchronize()
        # The respawn, observed even when the learner finished first.
        t_wait = time.monotonic()
        respawned = _wait_for(lambda: next((e for e in events
                                            if e["event"] == "replica_respawned"), None),
                              "central_fleet: replica 0's respawn", 300)
        _wait_for(lambda: fleet.router.stats()["endpoints"]["0"]["healthy"],
                  "central_fleet: replica 0 back in rotation", 60)
        waited_s = time.monotonic() - t_wait
        contexts["respawned"] = card_contexts()
        mappings = {"replicas": {rid: device_mappings(rep.pid)
                                 for rid, rep in fleet.replicas.items()},
                    "learner": device_mappings(os.getpid())}
        varz = fleet.replica_varz()
        fleet_stats = fleet.stats()
        pids_now = {rep.pid for rep in fleet.replicas.values()}
    finally:
        stop_relay.set()
        fleet.stop()
    if relay["error"] is not None:
        raise AssertionError("central_fleet: the relay failed") from relay["error"]
    pipe = seen[0]
    fused, pool = pipe.fused, pipe.worker.pool
    section = final["inference"]
    reports = pool.worker_reports
    torn_replicas = {rid: ((v or {}).get("serving", {}).get("net") or {}).get("torn_frames")
                     for rid, v in varz.items()}
    fallback = {w: r["inference"]["fallback_steps"] for w, r in reports.items()}
    versions = {rid: (v or {}).get("serving", {}).get("param_version") for rid, v in varz.items()}
    checks = {
        "steps_reached": final["step"] >= steps and len(spans) == calls,
        "one_sampler_launch_per_call": launches == len(spans),
        "no_worker_death": pool.restarts == 0 and not pool.worker_errors
                           and set(reports) == {0, 1},
        "paramless_cuda_free_workers": pool.buffer is None and pool.store is None
                                       and not any(r["param_buffer"] or r["cuda_initialized"]
                                                   for r in reports.values()),
        "no_torn": section["torn_replies"] == 0 and section["errors"] == 0
                   and all(t == 0 for t in torn_replicas.values()),
        "no_fallback": not any(fallback.values()),
        "relayed_versions": section["param_version"] >= 3 and len(relay["pushes"]) >= 3,
        "killed_and_respawned": bool(kill) and fleet_stats["respawns"] >= 1
                                and fleet_stats["replicas"]["0"]["attempt"] >= 1,
        "respawn_full_synced": versions.get(0) == fleet_stats["param_version"],
        "a_context_per_replica": contexts["fleet_up"] == contexts["respawned"]
                                 == contexts["before"] + 2,
    }
    if not all(checks.values()):
        raise AssertionError(f"central_fleet: {checks}; inference {section}; torn "
                             f"{torn_replicas}; versions {versions}; fleet {fleet_stats}; "
                             f"contexts {contexts}; kill {kill}; "
                             f"events {events[-10:]}")
    call_ms = [s.elapsed_time(e) for s, e, *_ in spans]
    rate = K * (len(call_ms) - 1) / (sum(call_ms[1:]) / 1e3)
    base_ms = beside["fused_call_ms"]
    result = {
        "phase": "central_fleet", "card": card, "learner_steps": final["step"],
        "fused_calls": len(spans), "sampler_launches": launches, "loss": final["learner/loss"],
        "fused_call_ms": call_ms,
        "learner_steps_per_s_calls_after_first": rate,
        "learner_steps_per_s": final["step"] / final["train_s"],
        "beside_central_train": {
            "learner_steps_per_s": beside["learner_steps_per_s"],
            "learner_steps_per_s_calls": K * len(base_ms) / (sum(base_ms) / 1e3),
            "learner_steps_per_s_second_call": beside["learner_steps_per_s_second_call"]},
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "actor_fps": final["actor_fps"],
        "inference": {k: section.get(k) for k in (
            "selects", "requests", "replies", "retries", "reconnects", "torn_replies",
            "outages", "stall_ms", "param_version", "version_lag")},
        "rtt_while_learning": rtt_summary(
            {w: r["inference"]["rtt_state"] for w, r in reports.items()}, warm_rtt),
        "relay": {"pushes": len(relay["pushes"]),
                  "full": sum(p["full"] for p in relay["pushes"]),
                  "delta": sum(p["delta"] for p in relay["pushes"]),
                  "bytes": sum(p["bytes"] for p in relay["pushes"])},
        "kill": {"pid": kill.get("pid"), "at_step": kill.get("step"),
                 "to_respawned_s": respawned["t"] - kill["t"],
                 "waited_after_learner_s": waited_s},
        "fleet": {"start_s": t_fleet, "respawns": fleet_stats["respawns"],
                  "router": fleet_stats["router"], "param": fleet_stats["param"],
                  "param_version": fleet_stats["param_version"]},
        "replica_versions": versions, "replica_torn_frames": torn_replicas,
        "replica_pids": sorted(pids_now), "card_contexts": contexts,
        "device_mappings": mappings,
        "cuts": {"env": "catch:84 for SeaquestNoFrameskip-v4", "actors": "2 workers x 8",
                 "min_replay_mem_size": f"{DEDUP_WARMUP} for 50000",
                 "steps": f"{calls} fused calls ({steps} steps) for 2000000",
                 "replicas": "2 on the learner's card", "data_parallel": "1 for 4"},
        "wall_s": wall, "seconds": time.monotonic() - t0,
    }
    emit(result)
    return result


# --- the Atari stack and chaos (fake-atari, obs/chaos.py) -----------------------------

ATARI_GOLDEN = os.path.join(REPO_DIR, "tests", "fixtures", "atari_golden.npz")
# The chaos schedule of atari_train: mean seconds between faults of each
# kind, scaled so every kind fires within the phase's ~minute (config3's
# run would use its own cadence); one seed, so the fault sequence repeats.
CHAOS_SEED = 7
ATARI_CHAOS = {"kill_interval_s": 20.0, "torn_record_interval_s": 30.0,
               "sigstop_interval_s": 15.0, "sigstop_hold_s": 0.5,
               "stuck_stager_interval_s": 12.0, "stuck_stager_hold_s": 1.0,
               "shm_fill_interval_s": 15.0, "shm_fill_hold_s": 1.0,
               "env_latency_ms": 0.25}
CHAOS_KINDS = ("kill", "sigstop", "torn_record", "stuck_stager", "shm_fill")


def phase_atari_golden(card: str, steps: int = 400) -> dict:
    """The port's numpy ``ObsPreprocess`` (cv2's luminance and area resize,
    no cv2 needed) against the committed golden file, byte for
    byte; then the host time of one agent step of ``make_env("fake-atari")``
    (4 raw 210×160×3 frames, the 2-frame max-pool, gray and resize) and of
    the preprocess alone."""
    from ape_x_dqn_tpu_torch.envs import make_env
    from ape_x_dqn_tpu_torch.envs.atari import ObsPreprocess
    from ape_x_dqn_tpu_torch.envs.fake_atari import FakeAtariEnv

    class OneFrame:
        observation_shape, num_actions = (210, 160, 3), 1

        def __init__(self, frame):
            self.frame = frame

        def reset(self, seed=None):
            return self.frame

    t0 = time.monotonic()
    frames = 0
    with np.load(ATARI_GOLDEN) as z:
        while f"in_{frames}" in z.files:
            got = ObsPreprocess(OneFrame(z[f"in_{frames}"])).reset()
            if got.shape != (84, 84, 1) or not np.array_equal(got, z[f"out_{frames}"]):
                raise AssertionError(f"atari_golden: frame {frames} differs from the golden "
                                     "output")
            frames += 1
    if frames < 2:
        raise AssertionError(f"atari_golden: {frames} golden frames")
    env = make_env("fake-atari")
    env.reset()
    actions = np.random.default_rng(SEED).integers(0, env.num_actions, steps)
    t1 = time.perf_counter()
    for a in actions:
        r = env.step(int(a))
        if r.terminated or r.truncated:
            env.reset()
    step_us = (time.perf_counter() - t1) / steps * 1e6
    raw = FakeAtariEnv()
    raw.reset()
    pre = ObsPreprocess(OneFrame(raw.step(0).obs))
    t1 = time.perf_counter()
    for _ in range(steps):
        pre.reset()
    pre_us = (time.perf_counter() - t1) / steps * 1e6
    result = {"phase": "atari_golden", "card": card, "golden_frames": frames,
              "byte_exact": True, "obs_shape": list(r.obs.shape), "obs_dtype": str(r.obs.dtype),
              "host_us_per_agent_step": step_us, "host_us_per_preprocess": pre_us,
              "steps": steps, "seconds": time.monotonic() - t0}
    emit(result)
    return result


class ChaosController:
    """Drives the chaos of a live ``atari_train`` run from a thread.  Once
    both workers feed: one ``kill`` timed to the victim's respawn feeding
    again, then ``torn_record``, ``sigstop`` and ``shm_fill`` wherever the
    schedule has not reached them yet (``tools/chaos_soak.py``'s top-up);
    once the stager runs, a ``stuck_stager`` with the stager's heartbeat age
    and the staged rows sampled through it (the ingest lag); then
    ``/metrics`` against ``monkey.counts()``; then, after ``min_calls``
    fused calls and one call after the stall, it stops the run.
    ``/healthz`` is scraped every half second all through, each scrape with
    whether a stall was on."""

    def __init__(self, seen: list, K: int, min_calls: int = 3):
        self.seen, self.K, self.min_calls = seen, K, min_calls
        self.out: dict = {"healthz": [], "times": {}}
        self.call_steps: list = []
        self.error = None
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, daemon=True),
                         threading.Thread(target=self._poll_healthz, daemon=True)]

    def __enter__(self):
        from ape_x_dqn_tpu_torch.runtime.fused_dedup import FusedDedupLearner

        train, ctl = FusedDedupLearner.train, self
        self._train = train

        def counting(learner, *args, **kwargs):
            if ctl.seen:
                ctl.call_steps.append(ctl.seen[0].learner_step)
            return train(learner, *args, **kwargs)

        FusedDedupLearner.train = counting
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        from ape_x_dqn_tpu_torch.runtime.fused_dedup import FusedDedupLearner

        self._stop.set()
        for t in self._threads:
            t.join(300)
        FusedDedupLearner.train = self._train

    def _wait(self, cond, what: str, timeout: float = 300.0):
        deadline = time.monotonic() + timeout
        while not cond():
            if self._stop.is_set() or time.monotonic() > deadline:
                raise AssertionError(f"atari_train: timed out waiting for {what}")
            time.sleep(0.02)

    def _poll_healthz(self):
        while not self._stop.is_set():
            pipe = self.seen[0] if self.seen else None
            server = pipe.obs_server if pipe is not None else None
            if server is None:
                time.sleep(0.05)
                continue
            if pipe.stop_event.is_set():
                return   # the run is ending: its exporter closes
            monkey = pipe._chaos
            stalled = monkey.stager_stalled()
            t = time.monotonic()
            try:
                code, body = _get(f"{server.url}/healthz")
                failing = sorted(n for n, c in json.loads(body)["components"].items()
                                 if not c["ok"])
            except Exception as e:  # noqa: BLE001 — a scrape that did not answer
                if self.seen[0].obs_server is None:
                    return   # the run closed its exporter
                code, failing = None, [f"{type(e).__name__}: {e}"]
            self.out["healthz"].append((t, code, failing, stalled or monkey.stager_stalled()))
            self._stop.wait(0.5)

    def _run(self):
        try:
            self._drive()
        except BaseException as e:  # noqa: BLE001 — raised by the phase
            self.error = e
        finally:
            if self.seen:
                self.seen[0].stop_event.set()

    def _drive(self):
        out, t = self.out, self.out["times"]
        self._wait(lambda: self.seen and self.seen[0].obs_server is not None, "the exporter")
        pipe = self.seen[0]
        url, monkey, pool = pipe.obs_server.url, pipe._chaos, pipe.worker.pool
        self._wait(lambda: all(pool.chunks_by_worker.get(w, 0) > 0 for w in (0, 1)),
                   "chunks from both workers")
        # The forced kill, timed until its respawn feeds again.
        before = dict(pool.chunks_by_worker)
        procs = list(pool._procs)
        t["kill"] = time.monotonic()
        out["kill"] = rec = monkey.execute("kill")
        if "worker" not in rec:
            raise AssertionError(f"atari_train: the forced kill did nothing: {rec}")
        w = rec["worker"]
        self._wait(lambda: pool._procs[w] is not procs[w] and pool._procs[w].is_alive()
                   and pool.chunks_by_worker.get(w, 0) > before.get(w, 0) + 1,
                   f"worker {w} fed again")
        t["refed"] = time.monotonic()
        out["topped_up"] = []
        for kind in ("torn_record", "sigstop", "shm_fill"):
            # A torn kill whose ring was already salvaged, or a stop with no
            # live worker, is recorded as skipped: try again.
            for _ in range(5):
                if any(r["fault"] == kind and "skipped" not in r for r in list(monkey.log)):
                    break
                out["topped_up"].append(kind)
                monkey.execute(kind)
                self._wait(lambda: any(p.is_alive() for p in pool._procs), "a live worker")
        # The stall, once the stager runs (the learner is past warm-up).
        self._wait(lambda: "ingest_stager" in pipe.health._age_fns, "the ingest stager")
        age = pipe.health._age_fns["ingest_stager"]
        fused = pipe.fused
        samples = []
        stall = threading.Thread(target=monkey.execute, args=("stuck_stager",))
        t["stall"] = time.monotonic()
        stall.start()
        while stall.is_alive() or time.monotonic() - t["stall"] < 3.0:
            # (s since the stall, the stager's heartbeat age, rows staged and
            # not yet carved into blocks, whether the stall is on)
            samples.append((time.monotonic() - t["stall"], age(), fused.stager.staged_rows,
                            monkey.stager_stalled()))
            time.sleep(0.02)
        stall.join()
        out["stall_samples"] = samples
        # /metrics against the monkey's own counts (read until a fault of the
        # schedule does not land in between).
        for _ in range(5):
            counts = monkey.counts()
            code, body = _get(f"{url}/metrics")
            if monkey.counts() == counts:
                break
        out["metrics"] = (code, body.decode(), counts)
        # min_calls calls done, one of them wholly after the stall (a call
        # has ended when the next one enters).
        need = max(self.min_calls, len(self.call_steps) + 1) + 1
        self._wait(lambda: len(self.call_steps) >= need, "the calls after the stall")
        # No fault after this: every kill so far must be respawned before
        # the run stops.
        monkey.stop()
        kills = sum(1 for r in list(monkey.log)
                    if r["fault"] in ("kill", "torn_record") and "pid" in r)
        self._wait(lambda: pipe.supervisor.respawns.value >= kills, f"{kills} respawns", 120)
        t["stop"] = time.monotonic()


def _prom_counter(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"/metrics lacks {name}")


def atari_argv(steps: int) -> list:
    """``train.main``'s arguments for atari_train: config3's learner on the
    overlapped pipeline (``overlap_train``'s), process workers on the full
    DQN stack over fake-atari, the supervisor, the exporter and the chaos
    schedule of ``ATARI_CHAOS``."""
    K = DEDUP_K
    argv = config3_argv(steps, depth=2, sync_every=K, warmup=ATARI_WARMUP) + [
        "--set", "env.name=fake-atari", "--set", "env.frame_skip=4",
        "--set", "env.frame_stack=1", "--set", "env.episodic_life=true",
        "--set", "env.clip_rewards=true",
        "--set", "obs.export_port=0", "--set", "supervisor.enabled=true",
        "--set", "supervisor.crash_loop_window_s=30", "--set", "supervisor.crash_loop_budget=6",
        "--set", "supervisor.respawn_backoff_base_s=0.2",
        "--set", "supervisor.respawn_backoff_max_s=3.0",
        "--set", "chaos.enabled=true", "--set", f"chaos.seed={CHAOS_SEED}"]
    for k, v in ATARI_CHAOS.items():
        argv += ["--set", f"chaos.{k}={v}"]
    return argv


def phase_atari_train(sampling, card: str, beside: dict) -> dict:
    """This slice's main path: config3's learner (``overlap_train``'s:
    the 2M dedup ring, sample-ahead K = 2048, bf16 ν and target, depth 2,
    a sync every K) fed by 2 process workers × 8 actors on the full DQN
    stack over fake-atari (frame skip 4, frame stack 1, episodic life,
    reward clip: 84×84×1 uint8), under the seeded chaos schedule
    (``ATARI_CHAOS``, the workers' envs in ``SlowEnv``), driven by
    ``ChaosController``.  Checks: every kind of ``CHAOS_KINDS`` executed at
    least once and none failed; every injected torn record detected at
    salvage and never delivered (the transport's torn count covers them and
    every delivered row was staged); respawns ≥ kills + torn kills, 0
    quarantines; the learner's step strictly increasing across calls;
    ``chaos/<kind>`` on ``/metrics`` equal to ``monkey.counts()``;
    ``/healthz`` answering at every scrape, any 503 naming only
    ``ingest_stager`` and only during a stall; one sampler launch per fused
    call; the workers' envs wrapped (``env_latency_ms``); no /dev/shm
    segment left, the ``ShmFiller``'s included.  Reports learner steps/s
    per call and actor fps beside ``overlap_train``'s (``beside``),
    frames per transition, dead slots, the ingest lag across the stall and
    kill → fed again."""
    import torch

    K = DEDUP_K
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sampling.sample_indices.launches = 0
    with capture_pipelines() as seen, timed_fused_calls() as spans, \
            ChaosController(seen, K) as ctl:
        final, wall = run_train(atari_argv(64 * K))
    launches = sampling.sample_indices.launches
    torch.cuda.synchronize()
    if ctl.error is not None:
        raise AssertionError(f"atari_train: {ctl.error}") from ctl.error
    out, t = ctl.out, ctl.out["times"]
    pipe = seen[0]
    fused, pool, monkey = pipe.fused, pipe.worker.pool, pipe._chaos
    calls = len(spans)
    if type(fused).__name__ != "FusedDedupLearner" or fused.replay.capacity != DEDUP_SLOTS:
        raise AssertionError(f"atari_train ran {type(fused).__name__}")
    if launches != calls or calls < 3 or final["step"] != calls * K:
        raise AssertionError(f"atari_train: {launches} sampler launches, {final['step']} "
                             f"steps in {calls} fused calls")
    steps = ctl.call_steps
    if len(steps) != calls or any(b <= a for a, b in zip(steps, steps[1:])):
        raise AssertionError(f"atari_train: learner steps at each call {steps}")
    obs_shape = tuple(fused.replay.frames.shape[1:])
    if obs_shape != (84, 84, 1) or pipe.cfg.env.name != "fake-atari":
        raise AssertionError(f"atari_train: frames {obs_shape} of {pipe.cfg.env.name}")
    # The faults.
    log = list(monkey.log)
    counts = monkey.counts()
    failed = [r for r in log if "failed" in r]
    done = {k: sum(1 for r in log if r["fault"] == k and "skipped" not in r) for k in CHAOS_KINDS}
    if failed or any(done[k] < 1 for k in CHAOS_KINDS):
        raise AssertionError(f"atari_train: faults {counts}, executed {done}, failed {failed}")
    torn = [r for r in log if r["fault"] == "torn_record" and "garbage_bytes" in r]
    kills = [r for r in log if r["fault"] in ("kill", "torn_record") and "pid" in r]
    xp = pool.transport_stats()
    stager = fused.stager
    if not torn or xp["torn_records"] < len(torn) or pool.worker_errors:
        raise AssertionError(f"atari_train: {len(torn)} torn records injected, "
                             f"{xp['torn_records']} detected, errors {pool.worker_errors}")
    # A torn record delivered would have failed its decode in the pump (a
    # worker error); what the learner staged came from decoded chunks only.
    if stager.rows_in > xp["transitions"]:
        raise AssertionError(f"atari_train: {xp['transitions']} transitions delivered, "
                             f"{stager.rows_in} staged")
    sup = final["supervisor"]
    if sup["respawns"] < len(kills) or sup["quarantines"] != 0 or pool.quarantined:
        raise AssertionError(f"atari_train: {len(kills)} kills, supervisor {sup}")
    # /metrics against the monkey.
    code, text, at_scrape = out["metrics"]
    scraped = {k: _prom_counter(text, f"apex_chaos_{k}_total") for k in monkey.KINDS}
    want = {k: float(at_scrape.get(k, 0)) for k in monkey.KINDS}
    if code != 200 or scraped != want:
        raise AssertionError(f"atari_train: /metrics chaos counters {scraped}, monkey {want}")
    # /healthz all through.
    scrapes = out["healthz"]
    stale = pipe.cfg.obs.heartbeat_stale_s
    stalls = [(r["t"], r["t"] + r["hold_s"]) for r in log if r["fault"] == "stuck_stager"]
    bad = [s for s in scrapes if s[1] is None or (s[1] != 200 and not (
        s[1] == 503 and s[2] == ["ingest_stager"]))]
    late = [s for s in scrapes if s[1] == 503 and not s[3]]
    if not scrapes or bad or late:
        raise AssertionError(f"atari_train: /healthz {bad or late}")
    reports = pool.worker_reports
    if not reports or any(r["env_latency_ms"] != ATARI_CHAOS["env_latency_ms"]
                          or r["cuda_initialized"] for r in reports.values()):
        raise AssertionError(f"atari_train: worker reports {reports}")
    leftover = [n for n in os.listdir("/dev/shm") if f"_{os.getpid()}_" in n]
    if leftover:
        raise AssertionError(f"atari_train: segments left in /dev/shm: {leftover}")
    # The numbers.
    call_ms = [s.elapsed_time(e) for s, e, *_ in spans]
    samples = out["stall_samples"]
    in_stall = [s for s in samples if s[3]]
    base_ms = beside["fused_call_ms"]
    size = fused.size
    result = {
        "phase": "atari_train", "card": card, "learner_steps": final["step"],
        "fused_calls": calls, "sampler_launches": launches, "loss": final["learner/loss"],
        "fused_call_ms": call_ms,
        "learner_steps_per_s_per_call": [K / (ms / 1e3) for ms in call_ms],
        "learner_steps_per_s_calls_2_on": K * (calls - 1) / (sum(call_ms[1:]) / 1e3),
        "learner_steps_per_s": final["step"] / final["train_s"],
        "actor_fps": final["actor_fps"], "actor_steps": final["actor_steps"],
        "workers": {w: {"env_steps_per_s": r["env_steps"] / max(r["collect_s"], 1e-9),
                        "env_latency_ms": r["env_latency_ms"], "threads": r["threads"]}
                    for w, r in sorted(reports.items())},
        "beside_overlap_train": {
            "learner_steps_per_s_per_call": [K / (ms / 1e3) for ms in base_ms],
            "learner_steps_per_s_calls_2_on": K * (len(base_ms) - 1) / (sum(base_ms[1:]) / 1e3),
            "actor_fps": beside["actor_fps"], "workers": beside["workers"]},
        "frame_per_transition": stager.fseq / max(stager.rows_in, 1),
        "frames_staged": stager.fseq, "transitions_staged": stager.rows_in,
        "replay_size": size, "dead_slots": int((fused.replay.mass[:size] == 0).sum()),
        "dropped_carry": stager.dropped_carry,
        "faults": counts, "faults_executed": done, "topped_up": out["topped_up"],
        "schedule_first_60s": [e for e in monkey.schedule if e[0] <= 60.0],
        "torn_injected": len(torn), "transport": {k: xp[k] for k in (
            "chunks", "transitions", "salvaged_records", "torn_records", "ring_full_waits")},
        "supervisor": sup, "respawns_needed": len(kills),
        "metrics_chaos": scraped,
        "healthz": {"scrapes": len(scrapes), "not_200": [s for s in scrapes if s[1] != 200],
                    "stale_after_s": stale},
        "stager_stall": {"hold_s": ATARI_CHAOS["stuck_stager_hold_s"],
                         "max_heartbeat_age_s": max(a for _, a, _, _ in samples),
                         "uncarved_rows_at_start": samples[0][2],
                         "uncarved_rows_at_end": in_stall[-1][2] if in_stall else None,
                         # the stager's first beat after the stall ends
                         "beat_s_after_stall": next(
                             (x - in_stall[-1][0] for x, a, _, st in samples
                              if in_stall and x > in_stall[-1][0] and not st and a < 0.05),
                             None),
                         "uncarved_rows_3s_after_start": samples[-1][2],
                         "stalls": len(stalls)},
        "kill_to_fed_s": t["refed"] - t["kill"], "kill": out["kill"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "cuts": {"env": "Seaquest ROM absent: fake-atari (the full DQN stack over the "
                        "ALE-faithful fake emulator) for SeaquestNoFrameskip-v4",
                 "actors": "2 workers x 8 actors for 8 x 32",
                 "min_replay_mem_size": f"{ATARI_WARMUP} for 50000",
                 "steps": f"{calls} fused calls ({calls * K} steps) for 2000000, stopped "
                          "once the controller's faults were done",
                 "data_parallel": "1 for 4",
                 "chaos": "chaos intervals scaled to the phase (ATARI_CHAOS)"},
        "wall_s": wall, "seconds": time.monotonic() - t0,
    }
    emit(result)
    return result


def phase_chaos_restore(sampling, card: str) -> dict:
    """An incremental checkpoint chain of config3's learner at
    ``ckpt_train``'s 262 144 slots on fake-atari (8 thread actors, a save
    every K steps, a new base after each delta, the supervisor and the
    chaos monkey on with no schedule): fused calls until generation 1 of
    the chain is committed, and a clean stop; then
    ``monkey.execute("corrupt_chunk")`` damages a chunk of the live
    generation, then ``train.main`` with ``restore_from=true`` restores
    through the damaged chain, walking back (a delta: to the chain's good
    prefix; a base: to generation 0).  Checks: a ``degraded_restore`` event,
    ``supervisor.fallback_restores`` ≥ 1, the resume at the newest committed
    step, one more call trained past it, one sampler launch per call."""
    import shutil

    import torch

    from ape_x_dqn_tpu_torch.utils.checkpoint import latest_step
    from ape_x_dqn_tpu_torch.utils.checkpoint_inc import inc_dir, read_manifest

    K = DEDUP_K
    t0 = time.monotonic()
    root = os.path.join(CKPT_ROOT, "chaos")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    shm_before = _shm_segments()

    def argv(steps):
        return _ckpt_train_argv(root, steps, overlap=False) + [
            "--set", "env.name=fake-atari", "--set", "learner.checkpoint_base_every=1",
            "--set", "supervisor.enabled=true", "--set", "chaos.enabled=true",
            "--set", f"chaos.seed={CHAOS_SEED}"]

    gc.collect()
    torch.cuda.empty_cache()
    sampling.sample_indices.launches = 0
    stop = threading.Event()

    def second_generation(seen):
        # A base of this ring takes longer to write than a call, so saves
        # in between are skipped: stop once generation 1 is committed.
        while not stop.wait(0.1):
            m = read_manifest(inc_dir(root))
            if seen and m is not None and m["generation"] >= 1:
                seen[0].stop_event.set()
                return

    with capture_pipelines() as seen:
        watcher = threading.Thread(target=second_generation, args=(seen,), daemon=True)
        watcher.start()
        try:
            first, first_wall = run_train(argv(64 * K))
        finally:
            stop.set()
            watcher.join(10)
    first_launches = sampling.sample_indices.launches
    committed = latest_step(root)
    manifest = read_manifest(inc_dir(root))
    rec = seen[0]._chaos.execute("corrupt_chunk")
    del seen
    if committed != first["step"] or manifest["generation"] < 1 or "path" not in rec \
            or first_launches != first["step"] // K:
        raise AssertionError(f"chaos_restore: committed {committed} of {first['step']} steps, "
                             f"{first_launches} launches, manifest {manifest}, corruption {rec}")
    gc.collect()
    torch.cuda.empty_cache()
    sampling.sample_indices.launches = 0
    metrics = os.path.join(root, "resumed.jsonl")
    with observe_resume() as seen:
        final, wall = run_train(argv(committed + K) + [
            "--set", "learner.restore_from=true", "--set", "learner.pipeline_depth=2",
            "--set", f"learner.sync_every={K}", "--metrics-file", metrics])
    launches = sampling.sample_indices.launches
    events = [r for r in _jsonl(metrics) if r.get("event") == "degraded_restore"]
    sup = final["supervisor"]
    if not events or sup["fallback_restores"] < 1:
        raise AssertionError(f"chaos_restore: degraded_restore events {events}, "
                             f"supervisor {sup}")
    if seen["step"] != committed or final["step"] != committed + K or launches != 1:
        raise AssertionError(f"chaos_restore: resumed at {seen['step']} (committed "
                             f"{committed}), ended at {final['step']}, {launches} launches")
    fused = seen["pipe"].fused
    if fused.replay.capacity != CKPT_SLOTS or tuple(fused.replay.frames.shape[1:]) != (84, 84, 1):
        raise AssertionError(f"chaos_restore: ring {fused.replay.capacity} of "
                             f"{tuple(fused.replay.frames.shape[1:])}")
    leftover = _shm_segments() - shm_before
    if leftover:
        raise AssertionError(f"chaos_restore: segments left in /dev/shm: {sorted(leftover)}")
    result = {
        "phase": "chaos_restore", "card": card, "capacity": CKPT_SLOTS, "K": K,
        "first_run": {"steps": first["step"], "sampler_launches": first_launches,
                      "wall_s": first_wall, "manifest": manifest},
        "corruption": rec, "committed_step": committed,
        "degraded_restore": events, "fallback_restores": sup["fallback_restores"],
        "resumed": {"step": seen["step"], "ring_size": seen["size"],
                    "restore_s": seen["restore_s"], "final_step": final["step"],
                    "loss": final["learner/loss"], "wall_s": wall},
        "sampler_launches": launches,
        "cuts": {"capacity": f"{CKPT_SLOTS} for 2000000", "actors": "8 thread actors for 256",
                 "env": "Seaquest ROM absent: fake-atari",
                 "min_replay_mem_size": f"{CKPT_WARMUP} for 50000"},
        "seconds": time.monotonic() - t0,
    }
    del seen, fused
    shutil.rmtree(root, ignore_errors=True)
    emit(result)
    return result


class _RecordingRandom:
    """A ``random.Random`` stand-in that records every draw."""

    def __init__(self, rng):
        self._rng, self.draws = rng, []

    def random(self):
        x = self._rng.random()
        self.draws.append(x)
        return x


def phase_serve_delay(card: str, requests: int = 100, delay_ms: float = 5.0) -> dict:
    """``PolicyServer`` on the card with the chaos serving delay
    (``apply_delay_ms`` 5, ``delay_seed`` SEED) beside the same server
    without it and a CPU server with the same delay: one client, one
    observation per request, ``requests`` each.  Checks: the card's delay
    stream equals the CPU server's draw for draw; p50 latency at least
    3.75 ms (the jitter's low end) above the undelayed server's."""
    import torch

    from ape_x_dqn_tpu_torch.models.dueling import build_network
    from ape_x_dqn_tpu_torch.serving.server import PolicyServer

    obs_shape, A = (84, 84, 1), 18
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        net = build_network("conv", A, obs_shape)
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    obs = np.random.default_rng(SEED).integers(0, 256, (requests, *obs_shape), dtype=np.uint8)
    t0 = time.monotonic()
    out = {}
    for name, kw in (("plain", dict(device="cuda")),
                     ("delay", dict(device="cuda", apply_delay_ms=delay_ms, delay_seed=SEED)),
                     ("cpu_delay", dict(device="cpu", apply_delay_ms=delay_ms,
                                        delay_seed=SEED))):
        server = PolicyServer(net, params, max_batch=32, max_wait_ms=0.5, **kw)
        rec = None
        if server._delay_rng is not None:
            rec = server._delay_rng = _RecordingRandom(server._delay_rng)
        server.warmup(obs_shape)
        server.start()
        try:
            lat = []
            n = requests if name != "cpu_delay" else requests // 4
            for o in obs[:n]:
                t1 = time.perf_counter()
                server.act(o, timeout=60)
                lat.append((time.perf_counter() - t1) * 1e3)
        finally:
            server.close()
        out[name] = {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
                     "requests": n, "draws": rec.draws if rec is not None else None}
    gpu, cpu = out["delay"]["draws"], out["cpu_delay"]["draws"]
    if not cpu or gpu[:len(cpu)] != cpu or len(gpu) < requests:
        raise AssertionError(f"serve_delay: the card's delay stream {gpu[:4]}... differs from "
                             f"the CPU server's {cpu[:4]}...")
    rise = out["delay"]["p50_ms"] - out["plain"]["p50_ms"]
    if rise < 0.75 * delay_ms:
        raise AssertionError(f"serve_delay: p50 rose {rise:.3f} ms, want >= {0.75 * delay_ms}")
    result = {"phase": "serve_delay", "card": card, "delay_ms": delay_ms,
              "p50_rise_ms": rise, "stream_draws_compared": len(cpu),
              **{k: {kk: vv for kk, vv in v.items() if kk != "draws"} for k, v in out.items()},
              "seconds": time.monotonic() - t0}
    emit(result)
    return result


# -- host frame-dedup replay and the tiered store ------------------------------

SPILL_ROOT = os.path.join(REPO_DIR, "build", "spill_smoke")
ATARI_OBS = (84, 84, 1)
HOST_DEDUP_STEPS = 256         # was 512 (smoke time; host_dedup_cuts lists it)
# tier_train: a 32 MiB hot budget (~4 750 frames) under a warm-up that
# outgrows it, so the tier spills and faults inside the phase.
TIER_BUDGET = 32 << 20
TIER_WARMUP = 8_192
TIER_CKPT_EVERY = 128


def mem_info() -> dict:
    """``MemAvailable`` from /proc/meminfo and this process's ``VmRSS``, bytes."""
    out = {}
    for path, key in (("/proc/meminfo", "MemAvailable"), ("/proc/self/status", "VmRSS")):
        with open(path) as f:
            for line in f:
                if line.startswith(key + ":"):
                    out[key] = int(line.split()[1]) * 1024
    return out


def dedup_stream(sources=(1, 2), chunks=60, rows=64, gap=(2, 30), seed=SEED):
    """A seeded interleaved dedup chunk stream at the Atari frame shape: each
    source's chunks carry 2 rows into its previous chunk's frames; source
    ``gap[0]`` skips chunk_seq ``gap[1]`` (its carried rows must drop).
    Yields (priorities, DedupChunk)."""
    from ape_x_dqn_tpu_torch.types import DedupChunk

    rng = np.random.default_rng(seed)
    seq = {s: 0 for s in sources}
    prev_u = {s: 0 for s in sources}
    for _ in range(chunks):
        for src in sources:
            if (src, seq[src]) == gap:
                seq[src] += 1
            carry = 2 if prev_u[src] else 0
            U = rows + 1
            m = rows + carry
            chunk = DedupChunk(
                frames=rng.integers(0, 256, (U, *ATARI_OBS), dtype=np.uint8),
                obs_ref=np.concatenate([-np.arange(carry, 0, -1, dtype=np.int32),
                                        np.arange(rows, dtype=np.int32)]),
                next_ref=np.concatenate([np.zeros(carry, np.int32),
                                         np.arange(1, rows + 1, dtype=np.int32)]),
                action=rng.integers(0, 18, m).astype(np.int32),
                reward=rng.normal(size=m).astype(np.float32),
                discount=np.full(m, 0.97, np.float32),
                source=src, chunk_seq=seq[src], prev_frames=prev_u[src])
            yield (np.abs(rng.normal(size=m)) + 0.1).astype(np.float32), chunk
            seq[src] += 1
            prev_u[src] = U


def phase_host_dedup_parity(sampling) -> dict:
    """``tools/spill_smoke.py`` gate 1 on the port, on this machine's host:
    the numpy ``DedupReplay`` and the C++ ``NativeDedupReplay``
    (``n_stripes=1``) take one seeded stream of 84×84 chunks (C = 4 096,
    frame ratio 0.75: > 2 frame-ring wraps, frame death, a carry gap):
    identical slots after every add, identical stats, and for 24 samples
    identical indices and frame bytes, IS weights within rtol 2e-7 (libm's
    ``pow`` against numpy's), the same restamps applied to both.  A tiered
    twin of each (hot budget a fifth of the ring, ~64 KiB spans, spills
    forced between operations) gives byte-identical batches to its dense
    twin, with spills and fault reads > 0.  No sampler kernel launches."""
    import shutil
    import tempfile

    from ape_x_dqn_tpu_torch.replay.dedup import DedupReplay
    from ape_x_dqn_tpu_torch.replay.native_dedup import NativeDedupReplay

    t0 = time.monotonic()
    C, ratio = 4096, 0.75
    sampling.sample_indices.launches = 0
    os.makedirs(os.path.dirname(SPILL_ROOT), exist_ok=True)
    spill = tempfile.mkdtemp(prefix="host_dedup_parity_", dir=os.path.dirname(SPILL_ROOT))
    try:
        ring_bytes = int(round(C * ratio)) * int(np.prod(ATARI_OBS))
        budget = ring_bytes // 5
        reps = {
            "numpy": DedupReplay(C, ATARI_OBS, frame_ratio=ratio),
            "native": NativeDedupReplay(C, ATARI_OBS, frame_ratio=ratio),
            "numpy_tiered": DedupReplay(C, ATARI_OBS, frame_ratio=ratio,
                                        hot_frame_budget_bytes=budget,
                                        spill_dir=os.path.join(spill, "numpy")),
            "native_tiered": NativeDedupReplay(C, ATARI_OBS, frame_ratio=ratio,
                                               hot_frame_budget_bytes=budget,
                                               spill_dir=os.path.join(spill, "native")),
        }
        tiered = ("numpy_tiered", "native_tiered")
        rows = 0
        for p, chunk in dedup_stream():
            slots = {k: r.add(p, chunk) for k, r in reps.items()}
            for k, v in slots.items():
                if not np.array_equal(v, slots["numpy"]):
                    raise AssertionError(f"host_dedup_parity: {k} wrote other slots")
            for k in tiered:
                reps[k].spill_cold()
            rows += len(slots["numpy"])
        stats = {k: r.stats for k, r in reps.items()}
        if any(v != stats["numpy"] for v in stats.values()):
            raise AssertionError(f"host_dedup_parity: stats differ {stats}")
        if stats["numpy"]["frame_dead"] == 0 or stats["numpy"]["dropped_carry"] == 0:
            raise AssertionError(f"host_dedup_parity: the stream reached no frame death or "
                                 f"carry gap: {stats['numpy']}")
        # Each replay against its reference: the C core against the numpy
        # replay (IS weights to rtol 2e-7), each tiered twin against its
        # dense twin (everything byte-identical).
        ref_of = {"numpy": "numpy", "native": "numpy", "numpy_tiered": "numpy",
                  "native_tiered": "native"}
        w_rel = 0.0
        for t in range(24):
            b = {k: r.sample(32, beta=0.4, rng=np.random.default_rng(100 + t))
                 for k, r in reps.items()}
            for k, v in b.items():
                ref = b[ref_of[k]]
                same = (np.array_equal(v.indices, ref.indices)
                        and all(np.array_equal(getattr(v.transition, f), getattr(ref.transition, f))
                                for f in ("obs", "next_obs", "action", "reward", "discount")))
                if not same:
                    raise AssertionError(f"host_dedup_parity: sample {t} of {k} differs "
                                         f"from {ref_of[k]}'s")
                rel = float(np.max(np.abs(v.is_weights - ref.is_weights) / ref.is_weights))
                w_rel = max(w_rel, rel)
                if rel > (2e-7 if k == "native" else 0.0):
                    raise AssertionError(f"host_dedup_parity: IS weights of {k} off by {rel}")
            upd = np.abs(np.random.default_rng(500 + t).normal(size=32)) + 0.05
            for k, r in reps.items():
                r.update_priorities(b["numpy"].indices, upd)
                if k in tiered:
                    r.spill_cold()
        tier_stats = {k: reps[k].tier_stats() for k in tiered}
        for k, st in tier_stats.items():
            if st["spill_writes"] <= 0 or st["fault_reads"] <= 0:
                raise AssertionError(f"host_dedup_parity: {k} spilled {st['spill_writes']} and "
                                     f"faulted {st['fault_reads']}, want both > 0")
        for r in reps.values():
            tier = getattr(r, "tier", None)
            if tier is not None:
                tier.close()
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    launches = sampling.sample_indices.launches
    if launches != 0:
        raise AssertionError(f"host_dedup_parity: {launches} sampler launches, want 0")
    result = {"phase": "host_dedup_parity", "capacity": C, "frame_ratio": ratio,
              "frame_capacity": reps["numpy"].frame_capacity, "rows_added": rows,
              "stats": stats["numpy"], "samples_compared": 24,
              "is_weight_max_rel_diff": w_rel, "is_weight_rtol": 2e-7,
              "hot_budget_bytes": budget, "ring_bytes": ring_bytes,
              "tier": {k: {kk: st[kk] for kk in ("span_frames", "spill_writes", "spilled_bytes",
                                                 "fault_reads", "fault_bytes", "fault_ms")}
                       for k, st in tier_stats.items()},
              "sampler_launches": launches, "seconds": time.monotonic() - t0}
    emit(result)
    return result


def host_dedup_argv(steps: int, warmup: int) -> list:
    """``proc_host_train``'s run (phase 7's width, 2 worker processes × 4
    actors on catch:84, B = 32) with config3's host-side replay: the frame
    dedup ring at 2 000 000 slots, frame ratio 1.25, bf16 ν and target."""
    return ["--device", "cuda", "--steps", str(steps), "--log-every", "64",
            "--set", "actor.mode=process", "--set", "actor.num_workers=2",
            "--set", "actor.sync_every=100", *FULL_WIDTH,
            "--set", "replay.capacity=2000000", "--set", "replay.dedup=true",
            "--set", "replay.frame_ratio=1.25",
            "--set", "learner.second_moment_dtype=bfloat16",
            "--set", "learner.target_dtype=bfloat16",
            "--set", f"learner.min_replay_mem_size={warmup}"]


def check_state_on_card(phase: str, pipe) -> str:
    """The host loop's train state (params, target, ν) all on the card."""
    state = pipe.comps.state
    tensors = [*state.params.values(), *state.target_params.values(),
               *state.opt_state["nu"].values()]
    if pipe.fused is not None or not all(t.is_cuda for t in tensors):
        raise AssertionError(f"{phase}: the train state is not on the card")
    return str(tensors[0].device)


def host_dedup_cuts(steps: int, warmup: int) -> dict:
    return {"env": "catch:84 for SeaquestNoFrameskip-v4 (no Atari on the machine)",
            "actors": "2 workers x 4 actors for 8 x 32 (proc_host_train's)",
            "min_replay_mem_size": f"{warmup} for 50000",
            "steps": f"{steps} for 2000000", "data_parallel": "1 for 4"}


def host_replay_rates(phase: str, final: dict, pipe, launches: int, card: str) -> dict:
    """The gates and rates shared by host_dedup_train and tier_train: the
    train state on the card, 0 sampler launches, 0 frame-dead slots."""
    state = pipe.comps.state
    device = check_state_on_card(phase, pipe)
    if launches != 0:
        raise AssertionError(f"{phase}: {launches} sampler launches on the host path")
    replay = pipe.comps.replay
    if type(replay).__name__ != "DedupReplay":
        raise AssertionError(f"{phase}: the replay is a {type(replay).__name__}")
    if replay.stats["frame_dead"] != 0:
        raise AssertionError(f"{phase}: {replay.stats['frame_dead']} frame-dead slots")
    frame_bytes = int(np.prod(pipe.comps.obs_shape))
    fcount, count = replay._fcount, replay.total_added
    return {
        "phase": phase, "card": card, "learner_steps": final["step"],
        "loss": final["learner/loss"], "sampler_launches": launches,
        "train_state_on": device,
        "nu_dtype": str(next(iter(state.opt_state["nu"].values())).dtype),
        "target_dtype": str(next(iter(state.target_params.values())).dtype),
        "learner_steps_per_s": final["step"] / final["train_s"], "train_s": final["train_s"],
        "actor_fps": final["actor_fps"], "stage_us": final["stage_us"],
        "replay": {"capacity": replay.capacity, "frame_capacity": replay.frame_capacity,
                   "size": replay.size(), "transitions": count, "frames": fcount,
                   "frames_per_transition": fcount / max(count, 1),
                   "frame_bytes_per_transition": fcount * frame_bytes / max(count, 1),
                   "ring_bytes_per_slot": replay.frame_capacity * frame_bytes / replay.capacity,
                   "frames_nbytes": replay.frames_nbytes(), **replay.stats},
    }


def phase_host_dedup_train(sampling, card: str, beside: dict,
                           steps: int = HOST_DEDUP_STEPS) -> dict:
    """This slice's main path: config3's learner on host replay
    (``learner.device_replay=false``, ``replay.dedup=true``): the host
    ``DedupReplay`` at 2 000 000 slots (a lazily touched 17.64 GB frame
    ring), frame ratio 1.25, bf16 ν and target, B = 32, fed by
    ``proc_host_train``'s 2 worker processes on catch:84.  Checks: the step
    count, the train state on the card, 0 sampler launches (the host path
    samples on the CPU), 0 frame-dead slots, no CUDA in the workers, no
    /dev/shm segment left.  Reports learner steps/s, actor fps, frames and
    frame bytes per transition from the replay's own counters, and the
    process's RSS beside ``MemAvailable`` before and after, beside
    ``proc_host_train`` (the double-store at 100 000 slots)."""
    import torch

    t0 = time.monotonic()
    mem_before = mem_info()
    torch.cuda.synchronize()
    sampling.sample_indices.launches = 0
    with capture_pipelines() as seen, compute_apps() as apps:
        final, wall = run_train(host_dedup_argv(steps, warmup=2048))
    launches = sampling.sample_indices.launches
    pipe = seen[0]
    if final["step"] < steps:
        raise AssertionError(f"host_dedup_train: reached {final['step']} of {steps} steps")
    result = host_replay_rates("host_dedup_train", final, pipe, launches, card)
    check_workers("host_dedup_train", pipe.worker.pool, apps)
    mem_after = mem_info()
    frame_bytes = int(np.prod(ATARI_OBS))
    result.update({
        "mem_before": mem_before, "mem_after": mem_after,
        "rss_growth_bytes": mem_after["VmRSS"] - mem_before["VmRSS"],
        "rss_growth_per_written_frame": (mem_after["VmRSS"] - mem_before["VmRSS"])
        / max(result["replay"]["frames"], 1),
        f"beside_{beside['phase']}": {
            "learner_steps_per_s": beside["learner_steps_per_s"],
            "actor_fps": beside["actor_fps"], "frames_per_transition": 2.0,
            "frame_bytes_per_transition": 2 * frame_bytes,
            "ring_bytes_per_slot": 2 * frame_bytes,
            "replay_frames_nbytes": beside["replay_frames_nbytes"]},
        "cuts": host_dedup_cuts(steps, 2048),
        "wall_s": wall, "seconds": time.monotonic() - t0})
    emit(result)
    return result


@contextlib.contextmanager
def healthz_watch(seen, period_s: float = 0.5):
    """Scrape ``/healthz`` of the observed run every ``period_s`` once its
    exporter is up: a list of (status, body dict)."""
    out: list = []
    stop = threading.Event()

    def loop():
        while not stop.wait(period_s):
            pipe = seen[0] if seen else None
            port = getattr(pipe, "obs_port", None)
            if not port:
                continue
            try:
                code, body = _get(f"http://127.0.0.1:{port}/healthz")
                out.append((code, json.loads(body)))
            except OSError:
                pass

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join(60)


@contextlib.contextmanager
def observe_restore(seen):
    """Record the restored replay at the moment the observed run starts (its
    actors not yet draining into it) and the seconds the replay leg's
    restore took."""
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline
    from ape_x_dqn_tpu_torch.utils import checkpoint_inc

    load, run = checkpoint_inc.load_incremental_replay, AsyncPipeline.run
    info: dict = {}

    def timed_load(*args, **kwargs):
        t1 = time.monotonic()
        try:
            return load(*args, **kwargs)
        finally:
            info["restore_s"] = time.monotonic() - t1

    def observed(self, *args, **kwargs):
        seen.append(self)
        r = self.comps.replay
        info.update(size=r.size(), total_added=r.total_added,
                    batch=r.sample(32, beta=0.4, rng=np.random.default_rng(SEED)),
                    tier=r.tier_stats())
        return run(self, *args, **kwargs)

    checkpoint_inc.load_incremental_replay = timed_load
    AsyncPipeline.run = observed
    try:
        yield info
    finally:
        checkpoint_inc.load_incremental_replay = load
        AsyncPipeline.run = run


def phase_tier_train(sampling, card: str, beside: dict, steps: int = TIER_STEPS) -> dict:
    """``host_dedup_train``'s learner with the tiered store:
    ``replay.hot_frame_budget_bytes`` 32 MiB (~4 750 frames) under a warm-up
    of ``TIER_WARMUP`` rows, the spill file and an incremental checkpoint
    chain (a save every ``TIER_CKPT_EVERY`` steps) under ``SPILL_ROOT``,
    the exporter on.  Checks: at every JSONL record hot bytes ≤ budget ×
    ``spill_watermark_high`` plus the spans the prefetch queue's samples
    and one drained chunk can fault or write before the evictor thread's
    next pass; spilled bytes
    and fault reads > 0; ``/healthz`` 200 at every scrape with the
    ``tier_evictor`` heartbeat registered; 0 sampler launches, 0 frame-dead
    slots.  Then, the run stopped, a last delta of the quiescent replay is
    committed; the manifest's ``cold_ref_bytes`` > 0; a fresh
    ``train.main`` with ``learner.restore_from=true`` over the same spill
    file restores it (cold spans adopted by ref): its replay's size,
    total_added and a 32-row sample from a fixed generator equal the saved
    replay's, and it trains 64 more steps.  Reports the base's bytes
    against a dense base at the same fill, the restore's seconds and the
    fault ms p50/p99."""
    import shutil

    import torch

    from ape_x_dqn_tpu_torch.utils.checkpoint_inc import (
        IncrementalCheckpointer,
        inc_dir,
        read_manifest,
    )

    t0 = time.monotonic()
    shutil.rmtree(SPILL_ROOT, ignore_errors=True)
    spill, root = os.path.join(SPILL_ROOT, "spill"), os.path.join(SPILL_ROOT, "ckpt")
    tier_args = ["--set", f"replay.hot_frame_budget_bytes={TIER_BUDGET}",
                 "--set", f"replay.spill_dir={spill}",
                 "--set", f"learner.checkpoint_every={TIER_CKPT_EVERY}",
                 "--set", f"learner.checkpoint_dir={root}",
                 "--set", "learner.checkpoint_incremental=true",
                 "--set", "obs.export_port=0"]
    try:
        torch.cuda.synchronize()
        sampling.sample_indices.launches = 0
        records: list = []
        with capture_pipelines() as seen, compute_apps() as apps, healthz_watch(seen) as health:
            final, wall = run_train(host_dedup_argv(steps, warmup=TIER_WARMUP) + tier_args,
                                    records)
        launches = sampling.sample_indices.launches
        pipe = seen[0]
        if final["step"] < steps:
            raise AssertionError(f"tier_train: reached {final['step']} of {steps} steps")
        result = host_replay_rates("tier_train", final, pipe, launches, card)
        check_workers("tier_train", pipe.worker.pool, apps)
        replay = pipe.comps.replay
        tier = replay.tier
        # The evictor is a thread: between two of its passes the prefetch
        # queue's samples (PREFETCH_DEPTH batches ahead, each faulting up to
        # 2B spans inline) and one drained chunk (a worker's flush, its
        # frames' spans and one more at each end) land above the watermark.
        from ape_x_dqn_tpu_torch.runtime.async_pipeline import PREFETCH_DEPTH

        a = pipe.cfg.actor
        chunk_frames = a.flush_every * (a.num_actors // a.num_workers) + a.num_actors
        slack_spans = (PREFETCH_DEPTH * 2 * pipe.cfg.learner.replay_sample_size
                       + chunk_frames // tier.span_frames + 2)
        bound = TIER_BUDGET * pipe.cfg.replay.spill_watermark_high + slack_spans * tier.span_bytes
        hot = [r["replay_tier"]["hot_bytes"] for r in records if "replay_tier" in r]
        if not hot or max(hot) > bound:
            raise AssertionError(f"tier_train: hot bytes {max(hot, default=None)} over "
                                 f"{bound} at a JSONL record ({len(hot)} records)")
        stats = replay.tier_stats()
        if stats["spilled_bytes"] <= 0 or stats["fault_reads"] <= 0:
            raise AssertionError(f"tier_train: spilled {stats['spilled_bytes']} B, "
                                 f"{stats['fault_reads']} fault reads; want both > 0")
        with_evictor = [(c, b) for c, b in health if "tier_evictor" in b.get("components", {})]
        if not with_evictor or any(c != 200 for c, _ in health):
            raise AssertionError(f"tier_train: /healthz {[c for c, _ in health]}, "
                                 f"{len(with_evictor)} with tier_evictor; want 200 at every "
                                 "scrape and the heartbeat registered")
        # The run is stopped (workers joined): commit the quiescent replay's
        # last delta onto the chain, and keep what a restore must give back.
        last = IncrementalCheckpointer(root, replay, sync=True)
        last.save(final["step"])
        last.close()
        manifest = read_manifest(inc_dir(root))
        if not manifest or manifest.get("cold_ref_bytes", 0) <= 0:
            raise AssertionError(f"tier_train: manifest {manifest} holds no cold-span refs")
        want = {"size": replay.size(), "total_added": replay.total_added,
                "batch": replay.sample(32, beta=0.4, rng=np.random.default_rng(SEED))}
        base_file = os.path.join(inc_dir(root), manifest["chunks"][0])
        nf = min(replay._fcount, replay.frame_capacity)
        dense_base = nf * tier.frame_bytes + replay.size() * (8 + 8 + 4 + 4 + 4 + 1 + 8)
        hot_at_end = [r["replay_tier"]["hot_bytes"] for r in records if "replay_tier" in r]
        del seen[:], pipe, replay, tier, last
        gc.collect()
        # A fresh learner from the chain: restore_from=true over the same root.
        target = final["step"] + 64
        seen2: list = []
        with observe_restore(seen2) as restored:
            final2, wall2 = run_train(host_dedup_argv(target, warmup=TIER_WARMUP) + tier_args
                                      + ["--set", "learner.restore_from=true"])
        got = restored
        same = (got["size"] == want["size"] and got["total_added"] == want["total_added"]
                and np.array_equal(got["batch"].indices, want["batch"].indices)
                and np.array_equal(got["batch"].is_weights, want["batch"].is_weights)
                and all(np.array_equal(getattr(got["batch"].transition, f),
                                       getattr(want["batch"].transition, f))
                        for f in ("obs", "next_obs", "action", "reward", "discount")))
        if not same:
            raise AssertionError(f"tier_train: the restored replay (size {got['size']}, "
                                 f"added {got['total_added']}) is not the saved one "
                                 f"(size {want['size']}, added {want['total_added']})")
        if final2["step"] < target or not np.isfinite(final2["learner/loss"]):
            raise AssertionError(f"tier_train: the resumed run reached {final2['step']} "
                                 f"of {target}")
        result.update({
            "hot_budget_bytes": TIER_BUDGET, "hot_bytes_bound": bound,
            "hot_bytes_at_records": {"max": max(hot_at_end), "last": hot_at_end[-1],
                                     "records": len(hot_at_end)},
            "tier": {k: stats[k] for k in ("span_frames", "hot_bytes", "hot_spans",
                                           "cold_spans", "spilled_bytes", "spill_writes",
                                           "fault_reads", "fault_bytes", "fault_ms")},
            "healthz": {"scrapes": len(health), "with_tier_evictor": len(with_evictor),
                        "codes": sorted({c for c, _ in health})},
            "checkpoint": {"manifest_step": manifest["step"], "chunks": manifest["chunks"],
                           "cold_ref_bytes": manifest["cold_ref_bytes"],
                           "base_bytes": os.path.getsize(base_file),
                           "dense_base_bytes_at_fill": dense_base,
                           "ckpt": final.get("ckpt")},
            "restore": {"restore_s": restored["restore_s"], "size": got["size"],
                        "total_added": got["total_added"],
                        "fault_reads_at_restore": got["tier"]["fault_reads"],
                        "resumed_to": final2["step"], "loss": final2["learner/loss"],
                        "wall_s": wall2},
            "cuts": {**host_dedup_cuts(steps, TIER_WARMUP),
                     "hot_frame_budget_bytes": "32 MiB: the warm-up outgrows it"},
            "wall_s": wall, "seconds": time.monotonic() - t0})
        emit(result)
        return result
    finally:
        shutil.rmtree(SPILL_ROOT, ignore_errors=True)


def host_dedup_point(capacity: int = 2_000_000, n_stripes: int = 1, iters: int = 2000) -> dict:
    """JAX ``bench.py`` ``_host_dedup_bench`` on the port's
    ``NativeDedupReplay``: prefilled to half its slots from chunks of 4 096
    transitions over 4 097 fresh frames, then ``iters`` sample(32) +
    update pairs and 16 more chunks."""
    from ape_x_dqn_tpu_torch.replay.native_dedup import NativeDedupReplay
    from ape_x_dqn_tpu_torch.types import DedupChunk

    rng = np.random.default_rng(0)
    rep = NativeDedupReplay(capacity, ATARI_OBS, frame_ratio=1.25, n_stripes=n_stripes)
    M = 4096
    frames = rng.integers(0, 255, (M + 1, *ATARI_OBS), dtype=np.uint8)
    proto = dict(obs_ref=np.arange(M, dtype=np.int32),
                 next_ref=np.arange(1, M + 1, dtype=np.int32),
                 action=rng.integers(0, 4, M).astype(np.int32),
                 reward=rng.normal(size=M).astype(np.float32),
                 discount=np.full(M, 0.97, np.float32), prev_frames=M + 1)
    prio = (np.abs(rng.normal(size=M)) + 0.1).astype(np.float32)
    n_prefill = max(1, capacity // (2 * M))
    t_fill = time.perf_counter()
    for i in range(n_prefill):
        rep.add(prio, DedupChunk(frames=frames, source=1, chunk_seq=i, **proto))
    fill_s = time.perf_counter() - t_fill
    srng = np.random.default_rng(1)
    B = 32 - 32 % n_stripes
    t0 = time.perf_counter()
    for _ in range(iters):
        batch = rep.sample(B, rng=srng)
        rep.update_priorities(batch.indices, np.abs(rng.normal(size=B)) + 0.1)
    dt = time.perf_counter() - t0
    t1 = time.perf_counter()
    for i in range(16):
        rep.add(prio, DedupChunk(frames=frames, source=1, chunk_seq=n_prefill + i, **proto))
    dt_add = time.perf_counter() - t1
    out = {"n_stripes": n_stripes, "capacity": capacity,
           "occupancy": min(n_prefill * M, capacity),
           "sample_update_pairs_per_sec": iters / dt, "samples_per_sec": iters * B / dt,
           "add_transitions_per_sec": 16 * M / dt_add, "prefill_s": fill_s,
           "frames_gb": rep.frames_nbytes() / 1e9, "mem": mem_info()}
    del rep
    return out


def tiered_point(workdir: str, capacity: int = 200_000, iters: int = 1000,
                 hot_frac: float = 0.25) -> dict:
    """JAX ``bench.py`` ``_replay_tiered_bench`` (:695) on the port's native
    core: in core, then tiered with the hot budget at ``hot_frac`` of the
    ring and the ``TierEvictor`` on (2-frame spans), near-uniform then
    lognormal restamps; sample(32) + update pairs/s, spills and faults."""
    from ape_x_dqn_tpu_torch.replay.native_dedup import NativeDedupReplay
    from ape_x_dqn_tpu_torch.replay.tiered import TierEvictor
    from ape_x_dqn_tpu_torch.types import DedupChunk

    rng = np.random.default_rng(0)
    frame_bytes = int(np.prod(ATARI_OBS))
    ring_bytes = int(round(capacity * 1.25)) * frame_bytes
    hot_budget = int(ring_bytes * hot_frac)
    M = 4096
    frames = rng.integers(0, 255, (M + 1, *ATARI_OBS), dtype=np.uint8)
    proto = dict(obs_ref=np.arange(M, dtype=np.int32),
                 next_ref=np.arange(1, M + 1, dtype=np.int32),
                 action=rng.integers(0, 4, M).astype(np.int32),
                 reward=rng.normal(size=M).astype(np.float32),
                 discount=np.full(M, 0.97, np.float32), prev_frames=M + 1)
    prio = (np.abs(rng.normal(size=M)) + 0.1).astype(np.float32)
    n_prefill = max(1, capacity // (2 * M))

    def prefill(rep):
        for i in range(n_prefill):
            rep.add(prio, DedupChunk(frames=frames, source=1, chunk_seq=i, **proto))

    def run_loop(rep, skew=False):
        if rep.tier is not None:
            # Steady state: every dirty span written back, the hot tier
            # trimmed to its cap by clean drops before the timed loop.
            rep.tier_flush_dirty()
            while rep.tier_over_watermark():
                rep.spill_cold(max_spans=1024)
        srng, urng = np.random.default_rng(1), np.random.default_rng(2)

        def new_prio():
            if skew:
                return np.exp(2.0 * urng.normal(size=32)).astype(np.float32)
            return (np.abs(urng.normal(size=32)) + 0.1).astype(np.float32)

        for _ in range(min(128, iters // 4)):
            rep.update_priorities(rep.sample(32, rng=srng).indices, new_prio())
        t0 = time.perf_counter()
        for _ in range(iters):
            rep.update_priorities(rep.sample(32, rng=srng).indices, new_prio())
        return time.perf_counter() - t0

    rep = NativeDedupReplay(capacity, ATARI_OBS, frame_ratio=1.25)
    prefill(rep)
    dt_core = run_loop(rep)
    del rep
    rep = NativeDedupReplay(capacity, ATARI_OBS, frame_ratio=1.25,
                            hot_frame_budget_bytes=hot_budget, spill_dir=workdir,
                            spill_span_frames=2)
    evictor = TierEvictor(rep, poll_s=0.005)
    evictor.start()
    try:
        prefill(rep)
        dt_tier = run_loop(rep)
        stats = rep.tier_stats()
        dt_skew = run_loop(rep, skew=True)
        stats_skew = rep.tier_stats()
    finally:
        evictor.stop()
    if evictor.error is not None:
        raise AssertionError(f"host_dedup_2m: the evictor died: {evictor.error!r}")
    rep.tier.close()
    del rep
    return {"capacity": capacity, "occupancy": min(n_prefill * M, capacity),
            "ring_gb": ring_bytes / 1e9, "hot_budget_gb": hot_budget / 1e9, "hot_frac": hot_frac,
            "in_core_pairs_per_sec": iters / dt_core, "tiered_pairs_per_sec": iters / dt_tier,
            "tiered_pairs_per_sec_skewed": iters / dt_skew,
            "slowdown_x": dt_tier / dt_core, "slowdown_x_skewed": dt_skew / dt_core,
            "spill_writes": stats["spill_writes"], "spilled_gb": stats["spilled_bytes"] / 1e9,
            "fault_reads": stats["fault_reads"], "fault_gb": stats["fault_bytes"] / 1e9,
            "fault_reads_skewed_phase": stats_skew["fault_reads"] - stats["fault_reads"],
            "fault_ms": stats["fault_ms"], "hot_bytes_end": stats["hot_bytes"]}


def phase_host_dedup_2m(sampling) -> dict:
    """A host-only point: JAX ``bench.py``'s ``host_dedup_2m`` on the port's
    ``NativeDedupReplay`` at 2 000 000 slots (a 17.64 GB frame ring
    prefilled to half: ~7 GB touched), ``n_stripes`` 1 and 4, then its
    ``replay_tiered`` point at 200 000 slots (hot 25 % of the ring, the
    evictor on).  ``MemAvailable`` and the free disk under the spill dir
    first.  Checks: every rate > 0, spills and fault reads > 0 on the
    tiered point, the evictor alive, no sampler launch."""
    import shutil

    t0 = time.monotonic()
    sampling.sample_indices.launches = 0
    os.makedirs(SPILL_ROOT, exist_ok=True)
    disk = os.statvfs(SPILL_ROOT)
    before = {"mem": mem_info(), "disk_free_bytes": disk.f_bavail * disk.f_frsize,
              "spill_dir": SPILL_ROOT}
    emit({"phase": "host_dedup_2m_start", **before})
    try:
        points = [host_dedup_point(n_stripes=k) for k in (1, 4)]
        gc.collect()
        tiered = tiered_point(os.path.join(SPILL_ROOT, "tiered"))
    finally:
        shutil.rmtree(SPILL_ROOT, ignore_errors=True)
    for pt in points:
        if min(pt["sample_update_pairs_per_sec"], pt["add_transitions_per_sec"]) <= 0:
            raise AssertionError(f"host_dedup_2m: {pt}")
    if tiered["spill_writes"] <= 0 or tiered["fault_reads"] <= 0:
        raise AssertionError(f"host_dedup_2m: the tiered point spilled {tiered['spill_writes']} "
                             f"and faulted {tiered['fault_reads']}")
    if sampling.sample_indices.launches != 0:
        raise AssertionError("host_dedup_2m: sampler launches on a host-only point")
    result = {"phase": "host_dedup_2m", **before, "points": points, "tiered": tiered,
              "cpu_count": os.cpu_count(), "usable_cpus": len(os.sched_getaffinity(0)),
              "sampler_launches": 0, "seconds": time.monotonic() - t0}
    emit(result)
    return result


SVC_ROOT = os.path.join(REPO_DIR, "build", "replay_svc_smoke")
SVC_SLOTS = 2_000_000          # config3's replay.capacity, 1 000 000 per shard
SVC_KILL_AT = 120              # learner A's step at which one shard is SIGKILLed
SVC_STEPS = 400                # each learner's step budget
SVC_TIMEOUT_S = 2.0            # replay.service_request_timeout_s of both learners


def replay_svc_argv(endpoints: str, log: str, seed: int) -> list:
    """``python -m ape_x_dqn_tpu_torch.train`` arguments for one learner on
    the card attached to the fleet: config3's learner on host replay (conv
    dueling at full width, bf16 ν and target, B = 32), catch:84."""
    return [sys.executable, "-m", "ape_x_dqn_tpu_torch.train", "--device", "cuda",
            "--steps", str(SVC_STEPS), "--log-every", "16", "--metrics-file", log,
            *FULL_WIDTH, "--set", f"seed={seed}",
            "--set", f"replay.capacity={SVC_SLOTS}",
            "--set", "replay.service_mode=attach",
            "--set", f"replay.service_endpoints={endpoints}",
            "--set", f"replay.service_request_timeout_s={SVC_TIMEOUT_S}",
            "--set", "replay.service_probe_interval_s=0.25",
            "--set", "learner.second_moment_dtype=bfloat16",
            "--set", "learner.target_dtype=bfloat16",
            "--set", f"learner.min_replay_mem_size={DEDUP_WARMUP}",
            "--set", "actor.mode=process", "--set", "actor.sync_every=100"]


def _svc_rates(records: list, t_kill: float, t_up: float) -> dict:
    """Learner steps/s before the kill, during the outage and after it, from
    the (t, step) of one learner's periodic records; ``t_kill`` and
    ``t_up`` are on that learner's own clock (its record ``t``)."""
    pts = [(r["t"], r["step"]) for r in records if "step" in r and "t" in r and r["step"] > 0]

    def rate(lo, hi):
        win = [(t, s) for t, s in pts if lo <= t <= hi]
        if len(win) < 2 or win[-1][0] <= win[0][0]:
            return None
        return (win[-1][1] - win[0][1]) / (win[-1][0] - win[0][0])

    return {"before": rate(-1.0, t_kill), "during": rate(t_kill, t_up),
            "after": rate(t_up, float("inf"))}


def _svc_sample_probe(svc, fleet, n: int = 64) -> dict:
    """Sample RPCs of 32 rows from this process against every live shard,
    once over a zlib connection and once over a raw one: RTT p50/p99 and
    reply bytes per sample."""
    out = {}
    for codec in ("zlib", "off"):
        rtts, nbytes = [], []
        for s in fleet.shards:
            cli = svc.ShardClient(s.shard_id, "127.0.0.1", s.port, token=fleet.token,
                                  client_id=7000 + s.shard_id, incarnation=s.incarnation,
                                  codec=codec)
            try:
                for k in range(n):
                    t0 = time.perf_counter()
                    _flags, body = cli.request(svc.OP_SAMPLE,
                                               svc._SAMPLE_REQ.pack(32, 0.4, SEED + k),
                                               timeout=10.0)
                    rtts.append((time.perf_counter() - t0) * 1e3)
                    nbytes.append(len(body))
            finally:
                cli.close()
        out[codec] = {"rtt_ms_p50": float(np.percentile(rtts, 50)),
                      "rtt_ms_p99": float(np.percentile(rtts, 99)),
                      "reply_bytes_per_sample": float(np.mean(nbytes)), "samples": len(rtts)}
    return out


def phase_replay_svc_train(sampling, card: str, beside: dict) -> dict:
    """Replay as a service on the card: a 2-shard ``ReplayServiceFleet``
    (CPU processes, ``CUDA_VISIBLE_DEVICES`` empty) holding config3's
    2 000 000 slots (1 000 000 per shard, 84×84×1 uint8, zlib), each shard
    with its own checkpoint chain, and two learner processes on the card
    (``python -m ape_x_dqn_tpu_torch.train --device cuda``, config3's
    learner on host replay with ``replay.service_mode=attach``): learner A
    fed by 2 worker processes × 4 actors, learner B by one remote slot over
    tcp claimed by ``python -m ape_x_dqn_tpu_torch.host_join``.  Once A's
    step crosses ``SVC_KILL_AT`` the fleet SIGKILLs its seeded victim
    (``maybe_kill_at_step``): both learners must train on with
    ``shards_down`` 1 in their ``replay_svc`` sections; the dead shard's
    frozen chain is digested here, then the shard respawns, and its
    announced restore digest must equal the chain's (or the restore is a
    typed ``degraded_restore``); ``shards_down`` returns to 0, every parked
    write-back is flushed (``writeback_pending`` 0, ``writeback_flushed``
    > 0 across the learners), both learners train past the outage.  Gates:
    0 torn frames on every shard and learner, no CUDA context or device
    mapping in any shard process, 0 sampler launches in either learner, no
    /dev/shm segment left, every process exits 0."""
    import shutil

    from ape_x_dqn_tpu_torch.replay import service as svc
    from ape_x_dqn_tpu_torch.replay.buffer import PrioritizedReplay
    from ape_x_dqn_tpu_torch.utils.checkpoint_inc import load_incremental_replay, read_manifest

    t0 = time.monotonic()
    shutil.rmtree(SVC_ROOT, ignore_errors=True)
    os.makedirs(SVC_ROOT)
    shm_before = _shm_segments()
    contexts_before = card_contexts()
    fleet_events: list = []
    fleet = svc.ReplayServiceFleet(
        2, SVC_SLOTS, ATARI_OBS, root_dir=os.path.join(SVC_ROOT, "fleet"), codec="zlib",
        save_every_s=2.0, auto_respawn=False, kill_shard_at_step=SVC_KILL_AT,
        chaos_seed=SEED, on_event=lambda name, **f: fleet_events.append({"event": name, **f}))
    logs = {k: os.path.join(SVC_ROOT, f"learner_{k}.jsonl") for k in "ab"}
    errs = {k: os.path.join(SVC_ROOT, f"learner_{k}.err") for k in "ab"}
    join_path = os.path.join(SVC_ROOT, "join.json")
    procs: dict = {}
    log: dict = {}
    shard_pids: list = []

    def records(k):
        return _jsonl(logs[k]) if os.path.exists(logs[k]) else []

    def last(k, key):
        rec = next((r for r in reversed(records(k)) if key in r), None)
        return rec[key] if rec is not None else None

    def step(k):
        return int(last(k, "step") or 0)

    def stats(k):
        return last(k, "replay_svc") or {}

    def wait_for(cond, what: str, timeout: float = 120.0):
        deadline = time.monotonic() + timeout
        while not cond():
            for name, p in procs.items():
                if p.poll() is not None and name != "host_join":
                    raise AssertionError(f"replay_svc_train: {name} exited rc "
                                         f"{p.returncode} while waiting for {what}")
            if time.monotonic() > deadline:
                raise AssertionError(f"replay_svc_train: timed out waiting for {what}")
            time.sleep(0.1)

    try:
        marks = log["marks_s"] = {}     # seconds since the phase began

        def mark(name):
            marks[name] = time.monotonic() - t0

        fleet.start(timeout=120.0)
        mark("fleet_up")
        log["shard_spawn_s"] = [s.spawn_s for s in fleet.shards]
        shard_pids += [s.pid for s in fleet.shards]
        common = {"cwd": REPO_DIR, "stdout": subprocess.DEVNULL}
        procs["learner_a"] = subprocess.Popen(
            replay_svc_argv(fleet.endpoints_path, logs["a"], SEED)
            + ["--set", "actor.num_workers=2", "--set", "actor.num_actors=8"],
            stderr=open(errs["a"], "wb"), **common)
        procs["learner_b"] = subprocess.Popen(
            replay_svc_argv(fleet.endpoints_path, logs["b"], SEED + 1) + TCP_ARGS
            + ["--set", "actor.num_workers=1", "--set", "actor.remote_workers=1",
               "--set", f"actor.remote_join_path={join_path}",
               "--set", "actor.num_actors=8"],
            stderr=open(errs["b"], "wb"), **common)
        wait_for(lambda: os.path.exists(join_path), "learner B's join spec")
        procs["host_join"] = subprocess.Popen(
            [sys.executable, "-m", "ape_x_dqn_tpu_torch.host_join", "--join", join_path,
             "--host", "127.0.0.1"], cwd=REPO_DIR,
            stdout=open(os.path.join(SVC_ROOT, "host_join.jsonl"), "wb"),
            stderr=subprocess.DEVNULL)
        wait_for(lambda: step("a") > 0 and step("b") > 0, "both learners stepping", 240.0)
        mark("both_stepping")
        log["contexts_while_training"] = card_contexts()
        log["shard_device_mappings"] = [device_mappings(p) for p in shard_pids]
        kill = {}

        def crossed():
            rec = fleet.maybe_kill_at_step(step("a"))
            if rec is not None:
                kill.update(rec, t=time.monotonic())
            return bool(kill)

        wait_for(crossed, f"learner A's step {SVC_KILL_AT}")
        mark("kill")
        victim = kill["shard"]
        at_kill = {k: step(k) for k in "ab"}
        t_kill_rec = {k: records(k)[-1]["t"] for k in "ab"}
        wait_for(lambda: all(stats(k).get("shards_down", 0) == 1 for k in "ab"),
                 "shards_down 1 on both learners")
        log["kill_to_down_s"] = time.monotonic() - kill["t"]
        wait_for(lambda: all(step(k) > at_kill[k] + 20 for k in "ab"),
                 "both learners training through the outage")
        # The dead shard's frozen chain, digested here before the respawn.
        t_ref = time.monotonic()
        ref = PrioritizedReplay(SVC_SLOTS // 2, ATARI_OBS)
        ref_dir = fleet.shards[victim].ckpt_dir
        ref_step = load_incremental_replay(ref_dir, ref, fallback=True)
        ref_digest = ref.digest(with_crc=True)
        del ref
        gc.collect()
        log["frozen_chain_load_s"] = time.monotonic() - t_ref
        manifest = read_manifest(os.path.join(ref_dir, "replay_inc"))
        log["chain"] = {"chunks": len(manifest["chunks"]), "step": manifest["step"],
                        "base_bytes": os.path.getsize(os.path.join(
                            ref_dir, "replay_inc", manifest["chunks"][0])),
                        "chain_bytes": sum(os.path.getsize(os.path.join(
                            ref_dir, "replay_inc", c)) for c in manifest["chunks"])}
        mark("digested")
        fleet.respawn(victim, timeout=120.0)
        mark("respawned")
        shard = fleet.shards[victim]
        shard_pids.append(shard.pid)
        log["respawn_spawn_s"] = shard.spawn_s
        log["respawned_device_mappings"] = device_mappings(shard.pid)
        recovered = [e for e in shard.events if e.get("event") == "replay_shard_recovered"
                     and e.get("incarnation") == shard.incarnation]
        degraded = [e for e in shard.events if e.get("event") == "degraded_restore"]
        bit_exact = bool(recovered) and all(
            recovered[-1].get(f) == ref_digest[f] for f in ("count", "cursor", "size", "crc"))
        if not (bit_exact or degraded):
            raise AssertionError(f"replay_svc_train: restore {recovered} against the frozen "
                                 f"chain's digest {ref_digest} (step {ref_step}), no "
                                 "degraded_restore")
        wait_for(lambda: all(stats(k).get("shards_down", 1) == 0 for k in "ab"),
                 "shards_down 0 on both learners")
        t_up = time.monotonic()
        mark("up")
        log["kill_to_up_s"] = t_up - kill["t"]
        t_up_rec = {k: records(k)[-1]["t"] for k in "ab"}
        wait_for(lambda: all(stats(k).get("writeback_pending", 1) == 0 for k in "ab"),
                 "every parked write-back flushed")
        at_up = {k: step(k) for k in "ab"}
        probe = _svc_sample_probe(svc, fleet)
        wait_for(lambda: all(step(k) > at_up[k] + 20 for k in "ab"),
                 "both learners training past the outage")
        shard_stats = {}
        for s in fleet.shards:
            sc = svc.ShardClient(s.shard_id, "127.0.0.1", s.port, token=fleet.token,
                                 client_id=999, incarnation=s.incarnation)
            try:
                shard_stats[s.shard_id] = sc.shard_stats(timeout=10.0)
            finally:
                sc.close()
        mark("past_outage")
        rcs = {}
        for k in "ab":
            rcs[k] = procs[f"learner_{k}"].wait(timeout=600)
        mark("learners_exited")
    finally:
        for name, p in procs.items():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for name, p in procs.items():
            try:
                log.setdefault("rcs", {})[name] = p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                log.setdefault("rcs", {})[name] = p.wait(timeout=10)
        fleet.stop()
        tails = {}
        for k in "ab":
            try:
                with open(errs[k], "rb") as f:
                    tails[k] = f.read()[-1500:].decode(errors="replace")
            except OSError:
                pass
        log["stderr_tails"] = tails
    recs = {k: records(k) for k in "ab"}
    finals = {k: recs[k][-1] for k in "ab"}
    shutil.rmtree(SVC_ROOT, ignore_errors=True)
    if any(rcs[k] != 0 or not finals[k].get("final") for k in "ab"):
        raise AssertionError(f"replay_svc_train: learner rcs {rcs}, stderr {log['stderr_tails']}")
    svc_final = {k: finals[k]["replay_svc"] for k in "ab"}
    launches = {k: finals[k]["sampler_launches"] for k in "ab"}
    flushed = sum(s["writeback_flushed"] for s in svc_final.values())
    torn = {"shards": {k: v["torn_frames"] for k, v in shard_stats.items()},
            "learners": {k: v["rpc_torn"] for k, v in svc_final.items()}}
    if any(launches.values()):
        raise AssertionError(f"replay_svc_train: sampler launches {launches} on host replay")
    if flushed <= 0 or any(s["writeback_pending"] or s["shards_down"]
                           for s in svc_final.values()):
        raise AssertionError(f"replay_svc_train: replay_svc at the end {svc_final}")
    if any(torn["shards"].values()) or any(torn["learners"].values()):
        raise AssertionError(f"replay_svc_train: torn frames {torn}")
    if any(log["shard_device_mappings"]) or log["respawned_device_mappings"] \
            or log["contexts_while_training"] > contexts_before + 2:
        raise AssertionError(f"replay_svc_train: CUDA in a shard: contexts "
                             f"{contexts_before} -> {log['contexts_while_training']}, "
                             f"mappings {log['shard_device_mappings']} "
                             f"{log['respawned_device_mappings']}")
    if _shm_segments() - shm_before:
        raise AssertionError(f"replay_svc_train: /dev/shm left {_shm_segments() - shm_before}")
    if any(finals[k]["step"] <= at_up[k] for k in "ab"):
        raise AssertionError(f"replay_svc_train: final steps {[finals[k]['step'] for k in 'ab']}")
    rates = {k: _svc_rates(recs[k], t_kill_rec[k], t_up_rec[k]) for k in "ab"}
    op_ms = {k: {q: v["op_ms"].get(q) for q in ("p50_ms", "p99_ms", "count")}
             for k, v in shard_stats.items()}
    result = {
        "phase": "replay_svc_train", "card": card,
        "learner_steps": {k: finals[k]["step"] for k in "ab"},
        "loss": {k: finals[k]["learner/loss"] for k in "ab"},
        "sampler_launches": sum(launches.values()), "sampler_launches_by_learner": launches,
        "learner_steps_per_s": rates,
        "learner_steps_per_s_run": {k: finals[k]["step"] / finals[k]["train_s"]
                                    for k in "ab"},
        f"beside_{beside['phase']}": beside["learner_steps_per_s"],
        "actor_fps": {k: finals[k]["actor_fps"] for k in "ab"},
        "stage_us": {k: finals[k]["stage_us"] for k in "ab"},
        "kill": {k: v for k, v in kill.items() if k != "t"}, "steps_at_kill": at_kill,
        "steps_at_recovery": at_up,
        "restore": {"bit_exact": bit_exact, "degraded_restore": degraded,
                    "announced": recovered[-1] if recovered else None,
                    "frozen_chain_digest": ref_digest, "frozen_chain_step": ref_step},
        "sample_probe": probe, "shard_op_ms": op_ms,
        "reply_bytes_raw_over_zlib": probe["off"]["reply_bytes_per_sample"]
        / probe["zlib"]["reply_bytes_per_sample"],
        "add_dups": sum(v["add_dups"] for v in shard_stats.values()),
        "shards": {k: {f: v[f] for f in ("incarnation", "requests", "errors", "torn_frames",
                                         "bad_hellos", "stale_rejects", "add_dups", "size",
                                         "total_added", "saves", "reply_zlib", "reply_raw",
                                         "bytes_out", "logical_bytes_in")}
                   for k, v in shard_stats.items()},
        "replay_svc": svc_final, "writeback_flushed": flushed, "torn_frames": torn,
        "fleet": fleet.stats(), "fleet_events": [e["event"] for e in fleet_events],
        "contexts_before": contexts_before, **{k: v for k, v in log.items()
                                               if k != "stderr_tails"},
        "cuts": {"env": "catch:84 for SeaquestNoFrameskip-v4 (no Atari on the machine)",
                 "actors": "learner A 2 workers x 4 actors, learner B 1 remote slot x 8 "
                           "actors, for 8 x 32 per learner",
                 "min_replay_mem_size": f"{DEDUP_WARMUP} for 50000",
                 "steps": f"{SVC_STEPS} per learner for 2000000",
                 "data_parallel": "1 for 4"},
        "seconds": time.monotonic() - t0,
    }
    emit(result)
    return result


def main() -> int:
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_smoke = time.monotonic()
    from ape_x_dqn_tpu_torch.ops import sampling

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from ape_x_dqn_tpu_torch.replay import native

    t0 = time.monotonic()
    lib, log = sampling.build_library()
    emit({"phase": "build", "library": lib.name, "seconds": time.monotonic() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "Compiling entry" in ln]})
    t0 = time.monotonic()
    tree_lib, tree_log = native.build_library()
    emit({"phase": "build", "library": tree_lib.name, "compiler": native.CXX,
          "seconds": time.monotonic() - t0, "log": tree_log.strip()})
    from ape_x_dqn_tpu_torch.replay import native_dedup

    t0 = time.monotonic()
    core_lib, core_log = native_dedup.build_library()
    emit({"phase": "build", "library": core_lib.name, "compiler": native_dedup.CXX,
          "seconds": time.monotonic() - t0, "log": core_log.strip()})

    rows = phase_kernel(sampling)
    phase_atari_golden(card=smi)
    phase_parity()
    trained = phase_train(sampling, card=smi)
    phase_host_parity()
    host = phase_host_train(sampling, card=smi)
    host_sync = phase_host_sync(sampling)
    proc = phase_process(sampling, card=smi, device_replay=True)
    proc_host = phase_process(sampling, card=smi, device_replay=False)
    host_dedup_parity = phase_host_dedup_parity(sampling)
    host_dedup = phase_host_dedup_train(sampling, card=smi, beside=proc_host)
    tier = phase_tier_train(sampling, card=smi, beside=host_dedup)
    phase_host_dedup_2m(sampling)
    dedup_parity = phase_dedup_parity(sampling)
    graph_parity = phase_graph_parity(sampling)
    dedup = phase_dedup_train(sampling, card=smi)
    obs = phase_obs_train(sampling, card=smi, beside=dedup)
    obs_host = phase_obs_host(sampling, card=smi)
    tcp = phase_dedup_train(sampling, card=smi, tcp=True, beside=dedup, phase="tcp_train")
    remote = phase_remote_join(sampling, card=smi, beside=tcp)
    phase_serve_hub(card=smi, trained=tcp)
    del tcp["_params"]
    overlap = phase_dedup_train(sampling, card=smi, overlap=True, beside=dedup)
    atari = phase_atari_train(sampling, card=smi, beside=overlap)
    phase_serve_parity(card=smi)
    phase_serve_delay(card=smi)
    central = phase_dedup_train(sampling, card=smi, central=True, beside=dedup,
                                phase="central_train")
    central_fleet = phase_central_fleet(sampling, card=smi, beside=central)
    wide = phase_dedup_train(sampling, card=smi, central=True, actors=64,
                             phase="central_wide")
    wide_local = phase_dedup_train(sampling, card=smi, actors=64, beside=wide,
                                   phase="central_wide_local")
    attach = phase_serve_attach(sampling, card=smi)
    ckpt_parity = phase_ckpt_parity(sampling)
    ckpt_train, ckpt_root, ckpt_state = phase_ckpt_train(sampling, card=smi)
    phase_serve_checkpoint(smi, ckpt_root, ckpt_state)
    phase_serve_fleet(smi, ckpt_root, ckpt_state)
    del ckpt_state
    chaos_restore = phase_chaos_restore(sampling, card=smi)
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    # Last: its two learner processes are the only other CUDA contexts the
    # smoke puts on the card before obs_train's profiled captures otherwise.
    replay_svc = phase_replay_svc_train(sampling, card=smi, beside=proc_host)

    emit({"phase": "smoke", "seconds": time.monotonic() - t_smoke})
    # The sampler's main path stays atari_train (one sample-ahead launch per
    # call); this slice's host paths launch it 0 times, gated in each phase.
    main_row = next(r for r in rows if r["B"] == 65_536 and r["dead_share"] == 0.0)
    emit({"kernels": [{
        "name": "sampling",
        "route": "cuda",
        "source": "ape_x_dqn_tpu_torch/ops/csrc/sampling.cu",
        "replaces": "ape_x_dqn_tpu/ops/pallas/sampling.py:118",
        "launches": atari["sampler_launches"],
        "launches_by_path": {"device_replay": trained["sampler_launches"],
                             "host_replay": host["sampler_launches"],
                             "host_sync": host_sync["sampler_launches"],
                             "process_device_replay": proc["sampler_launches"],
                             "process_host_replay": proc_host["sampler_launches"],
                             "host_dedup_parity": host_dedup_parity["sampler_launches"],
                             "process_host_dedup": host_dedup["sampler_launches"],
                             "process_host_tiered": tier["sampler_launches"],
                             "replay_service": replay_svc["sampler_launches"],
                             "dedup_parity": dedup_parity["sampler_launches"],
                             "graph_parity": graph_parity["sampler_launches"],
                             "process_device_dedup": dedup["sampler_launches"],
                             "process_device_dedup_obs": obs["sampler_launches"],
                             "process_host_lineage": obs_host["sampler_launches"],
                             "process_device_dedup_tcp": tcp["sampler_launches"],
                             "process_device_dedup_remote_join":
                                 remote["sampler_launches"],
                             "process_device_dedup_overlapped":
                                 overlap["sampler_launches"],
                             "process_device_dedup_central": central["sampler_launches"],
                             "process_device_dedup_central_fleet":
                                 central_fleet["sampler_launches"],
                             "process_device_dedup_central_wide":
                                 wide["sampler_launches"],
                             "process_device_dedup_wide": wide_local["sampler_launches"],
                             "serve_attach": attach["sampler_launches"],
                             "ckpt_parity": ckpt_parity["sampler_launches"],
                             "ckpt_train": ckpt_train["sampler_launches"],
                             "process_device_dedup_atari_chaos": atari["sampler_launches"],
                             "chaos_restore": chaos_restore["sampler_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["cold_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cold_ms": main_row["cold_ms"],
        "warm_ms": main_row["warm_ms"],
        "roofline_share": main_row["roofline_share"],
        "grid": main_row["grid"],
        "at": {"C": 2_000_000, "B": 65_536},
        "shapes": rows,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ckpt-child"]:
        raise SystemExit(ckpt_child(sys.argv[2]))
    if sys.argv[1:2] == ["--serve-child"]:
        raise SystemExit(serve_child(sys.argv[2:]))
    raise SystemExit(main())
