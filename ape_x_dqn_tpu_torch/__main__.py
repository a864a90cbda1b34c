"""``python -m ape_x_dqn_tpu_torch`` → the CLI trainer (train.py)."""

from ape_x_dqn_tpu_torch.train import main

if __name__ == "__main__":
    raise SystemExit(main())
