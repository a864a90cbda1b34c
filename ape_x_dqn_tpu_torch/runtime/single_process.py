"""The β schedule of the single-process driver.

Only ``beta_schedule`` (``ape_x_dqn_tpu/runtime/single_process.py:41-45``)
is ported so far; the host-replay ``SingleProcessDriver`` waits for the
port of ``replay/buffer.py``.
"""

from __future__ import annotations


def beta_schedule(step: int, total_steps: int, beta0: float) -> float:
    """Anneal the IS exponent β from β₀ to 1 over training (standard PER)."""
    frac = min(1.0, step / max(1, total_steps))
    return beta0 + (1.0 - beta0) * frac
