"""CLI entry point: ``python -m ape_x_dqn_tpu_torch.train``.

Port of ``ape_x_dqn_tpu/train.py`` for the device-replay learner:

    python -m ape_x_dqn_tpu_torch.train --set learner.device_replay=true \\
        [--params-file F] [--set section.field=value ...] [--steps N] \\
        [--log-every N] [--device cuda|cpu]

JSONL metrics go to stdout; the resolved config
goes to stderr.  ``--device`` defaults to ``cuda`` and a missing card
raises; pass ``--device cpu`` to run on the CPU.
"""

from __future__ import annotations

import argparse
import sys

from ape_x_dqn_tpu_torch.config import load_config, to_dict
from ape_x_dqn_tpu_torch.utils.metrics import MetricLogger


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ape_x_dqn_tpu_torch.train",
        description="Ape-X DQN trainer, PyTorch/CUDA port (device-replay learner)",
    )
    p.add_argument("--params-file", default=None,
                   help="JSON config (native or reference parameters.json format)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="PATH=VALUE",
                   help="config override, e.g. --set actor.num_actors=64")
    p.add_argument("--steps", type=int, default=None,
                   help="learner steps (default: config)")
    p.add_argument("--log-every", type=int, default=500)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    cfg = load_config(args.params_file, overrides=args.overrides)
    print("config:", to_dict(cfg), file=sys.stderr)
    from ape_x_dqn_tpu_torch.runtime.async_pipeline import AsyncPipeline

    pipe = AsyncPipeline(cfg, logger=MetricLogger(stream=sys.stdout),
                         log_every=args.log_every, device=args.device)
    final = pipe.run(learner_steps=args.steps)
    print("final:", final, file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
