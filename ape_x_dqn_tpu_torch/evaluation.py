"""Greedy evaluation + human-normalized Atari scoring.

Port of ``ape_x_dqn_tpu/evaluation.py``: ``canonical_game``,
``human_normalized``, ``median_human_normalized``, ``make_evaluator``,
``log_result``, ``EvalResult`` and ``GreedyEvaluator``, with the score
table copied.  A greedy eval fleet (ε ≈ 0.001, no n-step emission, no
training side effects) scores the policy itself; hns = (score − random) /
(human − random), and the suite headline is the median hns over games.
The policy forward runs through the port's ``build_policy_step`` on
``device``.  The human/random baselines are the standard published table
of the DQN/Rainbow/Ape-X papers.
"""

from __future__ import annotations

import re
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

# game id (tools/sweep.py spelling) -> (random score, human score).
ATARI_HUMAN_RANDOM = {
    "Alien": (227.8, 7127.7),
    "Amidar": (5.8, 1719.5),
    "Assault": (222.4, 742.0),
    "Asterix": (210.0, 8503.3),
    "Asteroids": (719.1, 47388.7),
    "Atlantis": (12850.0, 29028.1),
    "BankHeist": (14.2, 753.1),
    "BattleZone": (2360.0, 37187.5),
    "BeamRider": (363.9, 16926.5),
    "Berzerk": (123.7, 2630.4),
    "Bowling": (23.1, 160.7),
    "Boxing": (0.1, 12.1),
    "Breakout": (1.7, 30.5),
    "Centipede": (2090.9, 12017.0),
    "ChopperCommand": (811.0, 7387.8),
    "CrazyClimber": (10780.5, 35829.4),
    "Defender": (2874.5, 18688.9),
    "DemonAttack": (152.1, 1971.0),
    "DoubleDunk": (-18.6, -16.4),
    "Enduro": (0.0, 860.5),
    "FishingDerby": (-91.7, -38.7),
    "Freeway": (0.0, 29.6),
    "Frostbite": (65.2, 4334.7),
    "Gopher": (257.6, 2412.5),
    "Gravitar": (173.0, 3351.4),
    "Hero": (1027.0, 30826.4),
    "IceHockey": (-11.2, 0.9),
    "Jamesbond": (29.0, 302.8),
    "Kangaroo": (52.0, 3035.0),
    "Krull": (1598.0, 2665.5),
    "KungFuMaster": (258.5, 22736.3),
    "MontezumaRevenge": (0.0, 4753.3),
    "MsPacman": (307.3, 6951.6),
    "NameThisGame": (2292.3, 8049.0),
    "Phoenix": (761.4, 7242.6),
    "Pitfall": (-229.4, 6463.7),
    "Pong": (-20.7, 14.6),
    "PrivateEye": (24.9, 69571.3),
    "Qbert": (163.9, 13455.0),
    "Riverraid": (1338.5, 17118.0),
    "RoadRunner": (11.5, 7845.0),
    "Robotank": (2.2, 11.9),
    "Seaquest": (68.4, 42054.7),
    "Skiing": (-17098.1, -4336.9),
    "Solaris": (1236.3, 12326.7),
    "SpaceInvaders": (148.0, 1668.7),
    "StarGunner": (664.0, 10250.0),
    "Surround": (-10.0, 6.5),
    "Tennis": (-23.8, -8.3),
    "TimePilot": (3568.0, 5229.2),
    "Tutankham": (11.4, 167.6),
    "UpNDown": (533.4, 11693.2),
    "Venture": (0.0, 1187.5),
    "VideoPinball": (16256.9, 17667.9),
    "WizardOfWor": (563.5, 4756.5),
    "YarsRevenge": (3092.9, 54576.9),
    "Zaxxon": (32.5, 9173.3),
}

# Atari's 30-minute episode cap at 60 frames/s, per expected episode.
MAX_EPISODE_STEPS = 108_000

_SUFFIX_RE = re.compile(
    r"(NoFrameskip|Deterministic)?(-v\d+)?$", re.IGNORECASE
)


def canonical_game(env_name: str) -> str:
    """'PongNoFrameskip-v4' / 'ALE/Pong-v5' / 'gym:ALE/Pong-v5' / 'pong'
    -> 'Pong' (table key)."""
    if env_name.startswith("gym:"):
        # Factory scheme (envs.make_env): the real id is AFTER the colon.
        base = env_name.split(":", 1)[1]
    else:
        # Synthetic specs ('chain:6', 'random:84x84x1'): id is BEFORE it.
        base = env_name.split(":")[0]
    # Namespace prefixes (gymnasium v5 spells Atari ids 'ALE/Pong-v5');
    # anything before the last '/' is namespace, not game.
    base = _SUFFIX_RE.sub("", base.rsplit("/", 1)[-1])
    for key in ATARI_HUMAN_RANDOM:
        if key.lower() == base.lower():
            return key
    return base


def human_normalized(env_name: str, score: float) -> Optional[float]:
    """(score − random) / (human − random), or None for non-Atari envs."""
    entry = ATARI_HUMAN_RANDOM.get(canonical_game(env_name))
    if entry is None:
        return None
    random_s, human_s = entry
    return (score - random_s) / (human_s - random_s)


def median_human_normalized(scores: dict) -> Optional[float]:
    """Median hns over a {env_name: score} dict — the suite headline
    (BASELINE.json north star).  Envs without a table entry are excluded;
    returns None if none qualify."""
    hns = [
        v for v in (human_normalized(k, s) for k, s in scores.items())
        if v is not None
    ]
    return float(np.median(hns)) if hns else None


def make_evaluator(env_fns, network, env_name: str, seed: int,
                   device: str | torch.device = "cuda") -> "GreedyEvaluator":
    """The one construction spelling both runtimes use: at most four of the
    config's env constructors and the shared eval-seed offset, so eval
    cadence and seeding cannot drift between runtimes."""
    return GreedyEvaluator(
        env_fns[:4],
        network,
        env_name=env_name,
        seed=seed + 55,
        device=device,
    )


def log_result(logger, res: "EvalResult") -> None:
    """Log an EvalResult under the canonical metric names."""
    logger.log("eval/score", res.mean_score)
    if res.hns is not None:
        logger.log("eval/hns", res.hns)


class EvalResult(NamedTuple):
    episodes: List[float]     # per-episode returns, completion order
    mean_score: float
    median_score: float
    hns: Optional[float]      # human-normalized mean score (Atari only)


class GreedyEvaluator:
    """Greedy eval fleet: ε ≈ 0.001 flat (no ladder), batched lockstep envs,
    no emission and no training side effects.

    Runs on whatever thread calls :meth:`evaluate` (the runtimes call it
    from the learner thread at the ``--eval-every`` cadence, so evaluation
    time is learner downtime).  Exploration draws come from one generator
    on ``device`` that every call continues, so successive evaluations draw
    independent tie-breaks (the JAX evaluator mixes the call index into its
    key for the same end).
    """

    def __init__(
        self,
        env_fns: Sequence[Callable],
        network,
        env_name: str = "",
        epsilon: float = 0.001,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        from ape_x_dqn_tpu_torch.actors.pool import build_policy_step
        from ape_x_dqn_tpu_torch.envs.vector import SyncVectorEnv

        self.device = torch.device(device)
        self.envs = SyncVectorEnv(env_fns)
        self.env_name = env_name
        self._epsilons = torch.full((self.envs.num_envs,), float(epsilon),
                                    dtype=torch.float32, device=self.device)
        self._policy_step = build_policy_step(network, seed=seed + 777_001,
                                              device=self.device)
        self._seed = seed
        # Folded into the reset seed so successive evaluations start from
        # independent initial conditions.
        self._calls = 0

    def evaluate(self, params, episodes: int = 10) -> EvalResult:
        """Run until every env completes its share of ``episodes``.

        The quota is fixed per env (episodes split evenly across the
        vector), not first-``episodes``-to-complete globally: short, often
        low-scoring episodes would otherwise be overrepresented.
        Completions beyond an env's quota are ignored.  ``params`` may be
        host copies (the param store's form) or live device tensors.
        """
        params = {k: v.to(self.device) for k, v in params.items()}
        call = self._calls
        self._calls += 1
        obs = self.envs.reset(seed=self._seed + call * 9_973)
        k = self.envs.num_envs
        quota = np.full(k, episodes // k, np.int64)
        quota[: episodes % k] += 1
        counts = np.zeros(k, np.int64)
        scores: List[float] = []
        step = 0
        # Safety valve: even a policy that never finishes an episode
        # terminates (MAX_EPISODE_STEPS per expected episode).
        limit = MAX_EPISODE_STEPS * max(1, episodes)
        while (counts < quota).any() and step < limit:
            actions, _ = self._policy_step(params, obs, self._epsilons)
            vs = self.envs.step(actions)
            obs = vs.reset_obs
            step += 1
            for i in np.nonzero(~np.isnan(vs.episode_return))[0]:
                if counts[i] < quota[i]:
                    counts[i] += 1
                    scores.append(float(vs.episode_return[i]))
        mean = float(np.mean(scores)) if scores else float("nan")
        median = float(np.median(scores)) if scores else float("nan")
        return EvalResult(
            episodes=scores,
            mean_score=mean,
            median_score=median,
            hns=human_normalized(self.env_name, mean) if scores else None,
        )
