"""CLI entry point: ``python -m ape_x_dqn_tpu_torch.train``.

Port of ``ape_x_dqn_tpu/train.py``:

    python -m ape_x_dqn_tpu_torch.train [--params-file F] \\
        [--set section.field=value ...] [--mode async|sync] [--steps N] \\
        [--metrics-file F] [--eval-every N] [--eval-episodes N] \\
        [--tensorboard-dir D] [--profile-dir D] [--log-every N] [--device cuda|cpu]

``--mode async`` (the default) runs the actor ∥ replay ∥ learner pipeline:
the host-replay learner by default, the fused device-replay learner with
``--set learner.device_replay=true``; its actors run as a thread, or as
CPU-only worker processes with ``--set actor.mode=process --set
actor.num_workers=W``.  ``--mode sync`` runs the
deterministic single-process round-robin over the host replay (the golden
path).  JSONL metrics go to stdout and, with ``--metrics-file``, are
appended to that file too; the resolved config goes to stderr.
``--tensorboard-dir`` also writes each record's scalars as TensorBoard
events; ``--profile-dir`` traces the whole run with ``torch.profiler``
(CPU and CUDA activity) into a Chrome trace there
(``utils/profiling.trace``).  A live learner is traced on demand through
its exporter's ``/varz?trace=1`` (``--set obs.export_port=0``).  The JAX
CLI's ``--profile-port`` (``jax.profiler``'s live server) has no torch
counterpart and raises ``NotPortedError`` by name.  ``--device`` defaults
to ``cuda`` and a missing card raises; pass ``--device cpu`` to run on
the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from ape_x_dqn_tpu_torch.config import load_config, to_dict
from ape_x_dqn_tpu_torch.replay.buffer import NotPortedError
from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ape_x_dqn_tpu_torch.train",
        description="Ape-X DQN trainer, PyTorch/CUDA port",
    )
    p.add_argument("--params-file", default=None,
                   help="JSON config (native or reference parameters.json format)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="PATH=VALUE",
                   help="config override, e.g. --set actor.num_actors=64")
    p.add_argument("--mode", choices=("async", "sync"), default="async")
    p.add_argument("--steps", type=int, default=None,
                   help="learner steps (default: config)")
    p.add_argument("--metrics-file", default=None, help="also write JSONL here")
    p.add_argument("--eval-every", type=int, default=0, metavar="STEPS",
                   help="greedy-evaluate (ε≈0.001, no emission) every N learner "
                   "steps, logging eval/score and, for Atari games, eval/hns; "
                   "0 disables")
    p.add_argument("--eval-episodes", type=int, default=10,
                   help="episodes per evaluation pass")
    p.add_argument("--tensorboard-dir", default=None,
                   help="also write scalar metrics as TensorBoard events here")
    p.add_argument("--log-every", type=int, default=500)
    p.add_argument("--profile-dir", default=None,
                   help="trace the whole run with torch.profiler (CPU and CUDA "
                   "activity) into a Chrome trace in this dir")
    p.add_argument("--profile-port", type=int, default=None,
                   help="not part of the port: torch.profiler has no live server")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.profile_port is not None:
        raise NotPortedError("--profile-port: jax.profiler's live server has no "
                             "torch.profiler counterpart; trace a live learner through "
                             "/varz?trace=1 (obs.export_port) or the whole run with "
                             "--profile-dir")
    cfg = load_config(args.params_file, overrides=args.overrides)
    print("config:", to_dict(cfg), file=sys.stderr)
    logger = MetricLogger(stream=sys.stdout, path=args.metrics_file,
                          tensorboard_dir=args.tensorboard_dir)
    from ape_x_dqn_tpu_torch.utils.profiling import trace

    profile = trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    try:
        with profile:
            if args.mode == "async":
                _run_async(args, cfg, logger)
            else:
                _run_sync(args, cfg, logger)
    finally:
        logger.close()
    return 0


def _run_async(args, cfg, logger) -> None:
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline

    pipe = AsyncPipeline(cfg, logger=logger, log_every=args.log_every,
                         device=args.device, eval_every=args.eval_every,
                         eval_episodes=args.eval_episodes)
    final = pipe.run(learner_steps=args.steps)
    print("final:", final, file=sys.stderr)


def _run_sync(args, cfg, logger) -> None:
    from ape_x_dqn_tpu_torch.runtime.single_process import SingleProcessDriver

    if cfg.actor.mode == "process":
        raise ValueError("--mode sync steps its actors in the learner's process; "
                         "actor.mode=process applies to --mode async")
    driver = SingleProcessDriver(cfg, device=args.device)
    try:
        _drive_sync(args, cfg, logger, driver)
    finally:
        if getattr(driver.replay, "remote", False):
            driver.replay.close()   # the client's probe thread and sockets


def _drive_sync(args, cfg, logger, driver) -> None:
    from ape_x_dqn_tpu_torch.evaluation import log_result, make_evaluator

    evaluator = None
    next_eval = args.eval_every
    target = args.steps if args.steps is not None else cfg.learner.total_steps
    while driver.learner_step < target:
        res = driver.run_iteration()
        for e in res.episodes:
            logger.log("episode/return", e.episode_return)
            logger.log("episode/length", e.episode_length)
        if res.loss == res.loss:  # not NaN
            logger.log("learner/loss", res.loss)
            logger.log("learner/mean_q", res.mean_q)
        if args.eval_every and driver.learner_step >= next_eval:
            while next_eval <= driver.learner_step:
                next_eval += args.eval_every
            if evaluator is None:
                evaluator = make_evaluator(
                    driver.comps.env_fns, driver.network,
                    env_name=cfg.env.name, seed=cfg.seed, device=driver.device,
                )
            log_result(logger, evaluator.evaluate(
                driver.state.params, episodes=args.eval_episodes
            ))
        if driver.learner_step and driver.learner_step % args.log_every == 0:
            logger.emit(
                step=driver.learner_step,
                actor_steps=res.actor_steps,
                replay_size=res.replay_size,
            )
        if driver.fleet.step_count >= cfg.actor.T:
            break
    final = logger.emit(
        step=driver.learner_step,
        actor_steps=driver.total_actor_steps,
        replay_size=driver.replay.size(),
        final=True,
        # A service-attached replay's degradation surface.
        **({"replay_svc": driver.replay.stats()}
           if getattr(driver.replay, "remote", False) else {}),
    )
    print("final:", final, file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
