"""CLI serving mode: ``python -m ape_x_dqn_tpu_torch.serve``.

Port of ``ape_x_dqn_tpu/serve.py``:

    python -m ape_x_dqn_tpu_torch.serve (--attach | --checkpoint DIR |
        --param-hub HOST:PORT:TOKEN:RID:ATTEMPT | --param-tail DIR) \\
        [--replicas N] [--listen [HOST:]PORT] [--run-token T] [--params-file F] \\
        [--set section.field=value ...] [--duration S] [--clients N] \\
        [--steps N] [--metrics-file F] [--metrics-every S] [--obs-port PORT] \\
        [--device cuda|cpu]

``--attach`` runs the async trainer (``runtime/async_pipeline.py``) in a
thread of this process and serves its live ``ParamStore`` through a
``PolicyServer`` on the same device (its forwards on a high-priority stream
of their own, beside the learner's).  ``--checkpoint DIR`` serves a trained
policy from a checkpoint root (``serving/sources.CheckpointParamSource``,
JAX :285-330): the newest committed step, hot-reloaded whenever a newer
one commits (polled every ``serving.reload_poll_s``); an empty root exits
with 2 and ``no checkpoint under DIR``.  ``--param-hub`` subscribes to a
param hub (``serving/sources.SocketParamSource``: a full snapshot on
connect, page-deltas after, waiting up to
``serving.replica_spawn_timeout_s`` for the first); ``--param-tail DIR``
tails a ``ParamTailWriter`` chain (an empty dir exits with 2).  The config
must describe the network the params belong to.  ``serving.param_stale_s``
> 0 attaches ``runtime/supervisor.ServingStalenessPolicy``: past that many
seconds without a fresh snapshot the server sheds new requests with the
typed ``ServerOverloaded`` (``E_OVERLOADED`` on the socket) until one
lands; under ``--attach`` the trainer's supervisor ticks it, otherwise the
metrics loop does, every ``--metrics-every`` seconds.  ``--listen`` mounts
the socket front end (``serving/net_server.py``) and announces the bound port as a
``serving_listen`` JSONL event (port 0 = ephemeral); with ``--attach`` the
trainer's records then carry a ``serving_net`` section.  ``--obs-port``
(or ``obs.export_port``; JAX :369-393) mounts the ``/metrics``, ``/varz``
and ``/healthz`` exporter (``obs/exporter.py``) over a registry with the
server's stats as its ``serving`` provider and the batcher's heartbeat as
the ``serving_batcher`` component; under ``--attach`` that registry and
health are the trainer's (one scrape covers both halves, and the
trainer's own exporter gives up the port), and a staleness policy is a
``serving_params`` component.  ``--clients N``
runs N built-in closed-loop clients against the server; every
``--metrics-every`` seconds a ``serve/`` record is emitted.  ``--device``
defaults to ``cuda`` and a missing card raises.

``--replicas N`` with ``--checkpoint DIR`` is fleet mode (JAX :150-260,
``serving/router.ServingFleet``): N replica children (``serve --param-hub
... --listen HOST:0 --obs-port 0 --duration 0`` with this command's config
and ``--device``) behind the health-aware router on ``--listen`` (default
``serving.listen_host``/``listen_port``), fed by the fleet's param hub.
This process reads only the checkpoint root, on the CPU: every newer step
(polled every ``serving.reload_poll_s``) fans out to every replica as a
page-delta (a ``fleet_param_push`` event), the first in full.  The
router's bound port is a ``serving_listen`` event (mode ``router``);
``--obs-port`` mounts the exporter with the ``serving_router`` and
``serving_fleet`` providers and a ``router`` component that is stale
while no replica is healthy.  ``--replicas`` without ``--checkpoint``, or
over an empty root, exits with 2; a fleet that does not come up, with 3.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

from ape_x_dqn_tpu_torch.config import load_config, to_dict
from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ape_x_dqn_tpu_torch.serve",
        description="Batched Q-network policy serving with hot param reload, "
        "a socket front end and an N-replica routed fleet, PyTorch/CUDA port",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--attach", action="store_true",
                     help="run the async trainer in-process and serve its live params")
    src.add_argument("--checkpoint", default=None, metavar="DIR",
                     help="serve the newest checkpoint under DIR, hot-reloading "
                     "newer ones")
    src.add_argument("--param-hub", default=None, metavar="HOST:PORT:TOKEN:RID:ATTEMPT",
                     help="subscribe to a param hub: full snapshot on connect, "
                     "page-deltas after")
    src.add_argument("--param-tail", default=None, metavar="DIR",
                     help="tail a chain of param files (serving/sources.ParamTailWriter)")
    p.add_argument("--listen", default=None, metavar="[HOST:]PORT",
                   help="serve the socket request/reply protocol here (0 = "
                   "ephemeral; the bound port is announced as a serving_listen "
                   "JSONL event)")
    p.add_argument("--replicas", type=int, default=None, metavar="N",
                   help="fleet mode: N replica children behind the health-aware "
                   "router, fed from --checkpoint (0 = serving.replicas)")
    p.add_argument("--run-token", type=int, default=0, metavar="TOKEN",
                   help="v2 hellos (central-inference workers) must carry it or "
                   "are rejected at the handshake; 0 accepts any hello")
    p.add_argument("--params-file", default=None,
                   help="JSON config (native or reference format)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="PATH=VALUE",
                   help="config override, e.g. --set serving.max_batch=64")
    p.add_argument("--duration", type=float, default=10.0,
                   help="seconds to serve; 0 = until SIGTERM/SIGINT")
    p.add_argument("--clients", type=int, default=0,
                   help="built-in closed-loop clients (0 = idle serve)")
    p.add_argument("--steps", type=int, default=None,
                   help="learner steps to train (default: config total)")
    p.add_argument("--metrics-file", default=None, help="also write JSONL here")
    p.add_argument("--metrics-every", type=float, default=2.0)
    p.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                   help="mount the /metrics, /varz, /healthz exporter here (0 = "
                   "ephemeral; announced as an obs_exporter JSONL event); default "
                   "obs.export_port")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def _parse_listen(spec: str, default_host: str):
    """``[HOST:]PORT`` → (host, port)."""
    if ":" in spec:
        host, port = spec.rsplit(":", 1)
        return host or default_host, int(port)
    return default_host, int(spec)


def _install_stop_handlers(stop: threading.Event) -> None:
    """SIGTERM/SIGINT → a clean drain: sockets closed, final record
    flushed."""

    def _handler(signum, frame):  # noqa: ARG001
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _handler)
        except (ValueError, OSError):
            pass  # not the main thread (tests drive main() directly)


def _client_loop(server, obs_shape, stop, errors, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    while not stop.is_set():
        obs = rng.integers(0, 255, obs_shape, dtype=np.uint8)
        try:
            server.act(obs, timeout=30.0)
        except Exception:  # noqa: BLE001 — counted, loop continues
            errors.append(1)


def _fleet_sections(fleet) -> dict:
    st = fleet.stats()
    return {"serving_router": st["router"],
            "serving_fleet": {k: st[k] for k in ("param", "respawns", "spawned", "retires",
                                                 "retired", "param_version", "replicas")}}


def _run_fleet(args, cfg, logger) -> int:
    """--replicas N: the router, the param hub and N replica children,
    watching the checkpoint root and fanning new steps out as deltas."""
    from ape_x_dqn_tpu_torch.runtime.process_actors import network_and_template
    from ape_x_dqn_tpu_torch.serving.router import ServingFleet
    from ape_x_dqn_tpu_torch.serving.sources import CheckpointParamSource
    from ape_x_dqn_tpu_torch.utils.checkpoint import latest_step

    if not args.checkpoint:
        print("--replicas requires --checkpoint (the fleet's param feed)", file=sys.stderr)
        logger.close()
        return 2
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available "
                               "(pass --device cpu to serve on the CPU)")
    if latest_step(args.checkpoint) is None:
        print(f"no checkpoint under {args.checkpoint}", file=sys.stderr)
        logger.close()
        return 2
    s = cfg.serving
    n = args.replicas if args.replicas > 0 else s.replicas
    source = CheckpointParamSource(args.checkpoint, network_and_template(cfg)[2])
    params, have_step = source.get(-1)
    host, port = s.listen_host, s.listen_port
    if args.listen is not None:
        host, port = _parse_listen(args.listen, s.listen_host)
    replica_args = ["--device", args.device]
    if args.params_file:
        replica_args += ["--params-file", args.params_file]
    for ov in args.overrides:
        replica_args += ["--set", ov]
    fleet = ServingFleet(replicas=n, listen_host=host, listen_port=port,
                         probe_interval_s=s.probe_interval_s, replica_args=replica_args,
                         on_event=logger.event)
    logger.event("fleet_param_push", step=have_step, **fleet.publish(params))
    try:
        fleet.start(timeout=s.replica_spawn_timeout_s)
    except Exception as e:  # noqa: BLE001 — a fleet that does not come up is terminal
        print(f"fleet start failed: {e}", file=sys.stderr)
        fleet.stop()
        logger.close()
        return 3
    logger.event("serving_listen", port=fleet.port, host=host, replicas=n, mode="router")
    obs_server = None
    obs_port = args.obs_port if args.obs_port is not None else cfg.obs.export_port
    if obs_port is not None:
        from ape_x_dqn_tpu_torch.obs import Health, MetricsRegistry, ObsServer

        registry = MetricsRegistry()
        health = Health(stale_after_s=cfg.obs.heartbeat_stale_s)
        registry.register_provider("serving_router", fleet.router.stats)
        registry.register_provider("serving_fleet", fleet.stats)
        health.register("router",
                        lambda: 0.0 if fleet.router.stats()["healthy"] > 0 else 1e9,
                        stale_after_s=1.0)
        obs_server = ObsServer(registry, health, port=obs_port)
        logger.event("obs_exporter", port=obs_server.port, url=obs_server.url)
    stop = threading.Event()
    _install_stop_handlers(stop)
    try:
        deadline = time.monotonic() + args.duration if args.duration > 0 else None
        next_emit = time.monotonic() + args.metrics_every
        while not stop.is_set():
            if deadline is not None and time.monotonic() >= deadline:
                break
            # Poll the root at the reload cadence; emit at the metrics one.
            stop.wait(min(args.metrics_every, s.reload_poll_s))
            got = source.get(have_step)
            if got is not None:
                params, have_step = got[0], int(got[1])
                logger.event("fleet_param_push", step=have_step, **fleet.publish(params))
            if time.monotonic() >= next_emit:
                next_emit = time.monotonic() + args.metrics_every
                logger.emit(**_fleet_sections(fleet))
    finally:
        logger.emit(**_fleet_sections(fleet), final=True)
        fleet.stop()
        if obs_server is not None:
            obs_server.close()
        logger.close()
    return 0


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    cfg = load_config(args.params_file, overrides=args.overrides)
    print("serving config:", to_dict(cfg), file=sys.stderr)
    logger = MetricLogger(stream=sys.stdout, path=args.metrics_file)
    if args.replicas is not None:
        return _run_fleet(args, cfg, logger)

    from ape_x_dqn_tpu_torch.serving.net_server import ServingNetServer
    from ape_x_dqn_tpu_torch.serving.server import PolicyServer

    pipe = trainer_thread = None
    trainer_error: list = []
    stop = threading.Event()
    if args.attach:
        from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline

        # One process, both halves: the trainer owns the learner's stream,
        # the server's forwards run on a stream of their own on the same
        # device, and params flow learner -> store -> server in host memory.
        pipe = AsyncPipeline(cfg, logger=logger, log_every=10_000, device=args.device)
        comps, source = pipe.comps, pipe.store

        def train():
            try:
                pipe.run(learner_steps=args.steps)
            except BaseException as e:  # noqa: BLE001 — surfaced by main
                if not stop.is_set():     # not the stop this CLI asked for
                    trainer_error.append(e)

        trainer_thread = threading.Thread(target=train, name="attached-trainer",
                                          daemon=True)
    else:
        from ape_x_dqn_tpu_torch.runtime.components import build_components
        from ape_x_dqn_tpu_torch.serving import sources

        comps = build_components(cfg, device=args.device)
        if args.param_hub:
            source = sources.SocketParamSource(args.param_hub, comps.state.params)
        else:
            root, what, cls = ((args.param_tail, "param-tail chain", sources.ParamTailSource)
                               if args.param_tail else
                               (args.checkpoint, "checkpoint", sources.CheckpointParamSource))
            source = cls(root, comps.state.params)
            if source.version < 0:
                print(f"no {what} under {root}", file=sys.stderr)
                logger.close()
                return 2
    s = cfg.serving
    try:
        server = PolicyServer(
            comps.network, param_source=source,
            max_batch=s.max_batch, max_wait_ms=s.max_wait_ms,
            queue_capacity=s.queue_capacity, reload_poll_s=s.reload_poll_s,
            # A replica may come up before the hub's first publish reaches it.
            source_timeout_s=s.replica_spawn_timeout_s if args.param_hub else 30.0,
            # Chaos: a seeded per-batch service delay.
            apply_delay_ms=cfg.chaos.serving_delay_ms if cfg.chaos.enabled else 0.0,
            delay_seed=cfg.chaos.seed,
            device=comps.device,
        )
    except BaseException:
        if hasattr(source, "close"):
            source.close()
        raise
    server.warmup(comps.obs_shape)
    server.start()
    staleness = None   # a policy this loop ticks (the trainer's supervisor ticks its own)
    if s.param_stale_s > 0:
        if pipe is not None and pipe.supervisor is not None:
            pipe.supervisor.attach_serving(server, s.param_stale_s)
        else:
            from ape_x_dqn_tpu_torch.runtime.supervisor import ServingStalenessPolicy

            staleness = ServingStalenessPolicy(server, s.param_stale_s, on_event=logger.event)

    net_srv = None
    if args.listen is not None:
        host, port = _parse_listen(args.listen, s.listen_host)
        net_srv = ServingNetServer(
            server, host=host, port=port, max_request_bytes=s.max_request_bytes,
            run_token=args.run_token,
        ).start()
        server.attach_transport(net_srv.stats)
        logger.event("serving_listen", port=net_srv.port, host=host, mode="replica")
        if pipe is not None:
            # The trainer's records carry the socket plane as a section.
            pipe.register_jsonl_section("serving_net", net_srv.stats)
    obs_server = None
    obs_port = args.obs_port if args.obs_port is not None else cfg.obs.export_port
    if obs_port is not None:
        from ape_x_dqn_tpu_torch.obs import Health, MetricsRegistry, ObsServer

        if pipe is not None:
            registry, health = pipe.obs_registry, pipe.health
            pipe.close_exporter()   # this exporter takes the port
        else:
            registry = MetricsRegistry()
            health = Health(stale_after_s=cfg.obs.heartbeat_stale_s)
        registry.register_provider("serving", server.stats)
        health.register("serving_batcher",
                        lambda: time.monotonic() - server.batcher.heartbeat)
        if staleness is not None:
            health.register("serving_params", staleness.age_s, stale_after_s=s.param_stale_s)
        obs_server = ObsServer(registry, health, port=obs_port,
                               trace_hook=(pipe.trace_on_demand.trigger
                                           if pipe is not None else None))
        logger.event("obs_exporter", port=obs_server.port, url=obs_server.url)

    if trainer_thread is not None:
        trainer_thread.start()
    _install_stop_handlers(stop)
    errors: list = []
    clients = [
        threading.Thread(target=_client_loop,
                         args=(server, comps.obs_shape, stop, errors, cfg.seed + i),
                         name=f"serve-client-{i}", daemon=True)
        for i in range(args.clients)
    ]
    for c in clients:
        c.start()
    try:
        deadline = time.monotonic() + args.duration if args.duration > 0 else None
        while not stop.is_set():
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                stop.wait(min(args.metrics_every, remaining))
            else:
                stop.wait(args.metrics_every)
            if staleness is not None:
                staleness.check()
            extra = {"serving_net": net_srv.stats()} if net_srv else {}
            server.emit_metrics(logger, **extra)
            if trainer_thread is not None and not trainer_thread.is_alive():
                break
    finally:
        stop.set()
        for c in clients:
            c.join(timeout=5.0)
        if pipe is not None:
            pipe.stop_event.set()
            if trainer_thread.is_alive():
                trainer_thread.join(timeout=60.0)
        if net_srv is not None:
            net_srv.close()
        if obs_server is not None:
            obs_server.close()
        extra = {"serving_net": net_srv.stats()} if net_srv else {}
        server.emit_metrics(logger, final=True, **extra)
        server.close()
        if hasattr(source, "close"):
            source.close()
        logger.close()
    if trainer_error:
        raise RuntimeError("the attached trainer failed") from trainer_error[0]
    return 0 if not errors else 1


if __name__ == "__main__":
    raise SystemExit(main())
