"""Typed configuration — the port's own copy of ``ape_x_dqn_tpu/config.py``.

The same vocabulary (``env`` / ``actor`` / ``learner`` / ``replay``
sections, reference-format ``parameters.json`` files, ``--set
section.field=value`` overrides), cut down to the fields the port runs.
A key the port does not run raises rather than loading as a dead setting,
so a config written for the JAX package's other paths (process actors,
serving, checkpoints, data parallel) fails loudly here instead of running
something else.  The port owns this copy; it never imports the JAX
package's module.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence


@dataclasses.dataclass
class EnvConfig:
    name: str = "chain:10"
    state_shape: Optional[Sequence[int]] = None   # validated if given
    action_dim: Optional[int] = None              # validated if given


@dataclasses.dataclass
class ActorConfig:
    num_actors: int = 5                   # parameters.json:9
    T: int = 50_000                       # per-actor env steps, parameters.json:10
    num_steps: int = 3                    # n-step horizon, parameters.json:11
    epsilon: float = 0.4                  # parameters.json:12
    alpha: float = 7.0                    # ε-ladder exponent, parameters.json:13
    gamma: float = 0.99                   # parameters.json:14
    flush_every: int = 16                 # chunk emission period (steps)
    sync_every: int = 500                 # param poll period, parameters.json:16
    # "overlapping" = every step starts a window (stride 1); "strided" =
    # only n-aligned starts (stride n, the reference's emission).
    emission: str = "overlapping"


@dataclasses.dataclass
class LearnerConfig:
    total_steps: int = 500_000            # reference main.py:46
    q_target_sync_freq: int = 2500        # parameters.json:21
    min_replay_mem_size: int = 20_000     # parameters.json:22
    replay_sample_size: int = 32          # parameters.json:23
    optimizer: str = "rmsprop"            # "rmsprop" (parity) | "adam"
    learning_rate: float = 0.00025 / 4    # reference learner.py:26
    loss: str = "huber"                   # "huber" | "squared" (parity)
    max_grad_norm: Optional[float] = 40.0
    publish_every: int = 10               # param-store publish period (steps)
    # The replay ring lives in device memory and each fused call runs
    # steps_per_call sample/train/restamp steps.  The port runs only this
    # path so far; False (the host-replay path) is rejected at build time.
    device_replay: bool = False
    steps_per_call: int = 128             # K steps per fused call
    ingest_block: int = 256               # rows per device ring add
    # True samples all K batches of a call in one sampler launch from
    # call-entry priorities and restamps once after the K steps; False is
    # strict sequential PER (one sampler launch per step).
    sample_ahead: bool = False


@dataclasses.dataclass
class ReplayConfig:
    capacity: int = 100_000               # parameters.json:28 soft_capacity
    priority_exponent: float = 0.6        # parameters.json:29
    is_exponent: float = 0.4              # parameters.json:30


@dataclasses.dataclass
class ApexConfig:
    env: EnvConfig = dataclasses.field(default_factory=EnvConfig)
    actor: ActorConfig = dataclasses.field(default_factory=ActorConfig)
    learner: LearnerConfig = dataclasses.field(default_factory=LearnerConfig)
    replay: ReplayConfig = dataclasses.field(default_factory=ReplayConfig)
    network: str = "conv"                 # "conv" | "nature" | "mlp"
    seed: int = 0

    def validate(self) -> "ApexConfig":
        a, l, r = self.actor, self.learner, self.replay
        checks = [
            (a.num_actors >= 1, "actor.num_actors must be >= 1"),
            (a.num_steps >= 1, "actor.num_steps must be >= 1"),
            (0.0 <= a.epsilon <= 1.0, "actor.epsilon must be in [0, 1]"),
            (0.0 < a.gamma <= 1.0, "actor.gamma must be in (0, 1]"),
            (a.flush_every >= 1, "actor.flush_every must be >= 1"),
            (a.sync_every >= 1, "actor.sync_every must be >= 1"),
            (a.emission in ("overlapping", "strided"),
             f"unknown actor.emission: {a.emission}"),
            (a.emission != "strided" or a.flush_every >= a.num_steps,
             "actor.emission=strided requires flush_every >= num_steps"),
            (l.publish_every >= 1, "learner.publish_every must be >= 1"),
            (l.replay_sample_size >= 1, "learner.replay_sample_size must be >= 1"),
            (l.q_target_sync_freq >= 1, "learner.q_target_sync_freq must be >= 1"),
            (r.capacity >= l.replay_sample_size,
             "replay.capacity must be >= learner.replay_sample_size"),
            (l.min_replay_mem_size <= r.capacity,
             "learner.min_replay_mem_size must be <= replay.capacity"),
            (0.0 <= r.priority_exponent <= 1.0,
             "replay.priority_exponent must be in [0, 1]"),
            (0.0 <= r.is_exponent <= 1.0, "replay.is_exponent must be in [0, 1]"),
            (self.network in ("conv", "nature", "mlp"),
             f"unknown network kind: {self.network}"),
            (l.optimizer in ("rmsprop", "adam"),
             f"unknown optimizer kind: {l.optimizer}"),
            (l.loss in ("huber", "squared"), f"unknown loss kind: {l.loss}"),
            (l.steps_per_call >= 1, "learner.steps_per_call must be >= 1"),
            (l.ingest_block >= 1, "learner.ingest_block must be >= 1"),
            (not l.sample_ahead or l.device_replay,
             "learner.sample_ahead=True requires device_replay=True"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)
        return self


_REFERENCE_KEY_MAP = {
    # (reference section, reference key) -> (section attr, field, transform)
    ("env_conf", "name"): ("env", "name", str),
    ("env_conf", "state_shape"): ("env", "state_shape", tuple),
    ("env_conf", "action_dim"): ("env", "action_dim", int),
    ("Actor", "num_actors"): ("actor", "num_actors", int),
    ("Actor", "T"): ("actor", "T", int),
    ("Actor", "num_steps"): ("actor", "num_steps", int),
    ("Actor", "epsilon"): ("actor", "epsilon", float),
    ("Actor", "alpha"): ("actor", "alpha", float),
    ("Actor", "gamma"): ("actor", "gamma", float),
    ("Actor", "n_step_transition_batch_size"): ("actor", "flush_every", int),
    ("Actor", "Q_network_sync_freq"): ("actor", "sync_every", int),
    ("Learner", "T"): ("learner", "total_steps", int),
    ("Learner", "q_target_sync_freq"): ("learner", "q_target_sync_freq", int),
    ("Learner", "min_replay_mem_size"): ("learner", "min_replay_mem_size", int),
    ("Learner", "replay_sample_size"): ("learner", "replay_sample_size", int),
    ("Learner", "remove_old_xp_freq"): (None, None, None),  # no-op (ring evicts)
    ("Replay_Memory", "soft_capacity"): ("replay", "capacity", int),
    ("Replay_Memory", "priority_exponent"): ("replay", "priority_exponent", float),
    ("Replay_Memory", "importance_sampling_exponent"): ("replay", "is_exponent", float),
}


def from_reference_json(data: dict) -> ApexConfig:
    """Load a reference-format parameters.json dict.  Unknown keys raise.
    ``Learner.load_saved_state`` is accepted only when false: checkpoints
    are not part of the port yet."""
    cfg = ApexConfig()
    for section, keys in data.items():
        if not isinstance(keys, dict):
            raise ValueError(f"unknown top-level config entry: {section}")
        for key, value in keys.items():
            if (section, key) == ("Learner", "load_saved_state"):
                if value:
                    raise ValueError(
                        "Learner.load_saved_state: checkpoint restore is not "
                        "part of the port yet"
                    )
                continue
            mapping = _REFERENCE_KEY_MAP.get((section, key))
            if mapping is None:
                raise ValueError(f"unknown config key: {section}.{key}")
            attr, field, transform = mapping
            if attr is None:
                continue  # documented no-op
            setattr(getattr(cfg, attr), field, transform(value))
    return cfg.validate()


# Optional-typed fields where a CLI "none" legitimately means None.
_OPTIONAL_FIELDS = {"state_shape", "action_dim", "max_grad_norm"}


def _coerce(current: Any, raw: str, field: str = "") -> Any:
    if raw.lower() in ("none", "null") and field in _OPTIONAL_FIELDS:
        return None
    if current is None:
        for conv in (int, float):
            try:
                return conv(raw)
            except ValueError:
                continue
        return raw
    if isinstance(current, bool):
        low = raw.lower()
        if low in ("1", "true", "yes"):
            return True
        if low in ("0", "false", "no"):
            return False
        raise ValueError(f"{field}: expected a boolean, got {raw!r}")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    return raw


def apply_overrides(cfg: ApexConfig, overrides: Sequence[str]) -> ApexConfig:
    """Apply CLI ``section.field=value`` overrides (e.g.
    ``actor.num_actors=64``, ``network=mlp``)."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got: {item}")
        path, raw = item.split("=", 1)
        parts = path.split(".")
        obj = cfg
        for p in parts[:-1]:
            if not hasattr(obj, p):
                raise ValueError(f"unknown config path: {path}")
            obj = getattr(obj, p)
        field = parts[-1]
        if not hasattr(obj, field):
            raise ValueError(f"unknown config field: {path}")
        setattr(obj, field, _coerce(getattr(obj, field), raw, field))
    return cfg.validate()


def load_config(path: Optional[str] = None, overrides: Sequence[str] = ()) -> ApexConfig:
    """Load config: native JSON (sections matching dataclass fields) or
    reference-format parameters.json, then CLI overrides."""
    cfg = ApexConfig()
    if path:
        with open(path) as f:
            data = json.load(f)
        if any(s in data for s in ("env_conf", "Actor", "Learner", "Replay_Memory")):
            cfg = from_reference_json(data)
        else:
            cfg = _from_native_json(data)
    return apply_overrides(cfg, overrides)


_SECTIONS = {
    "env": EnvConfig, "actor": ActorConfig,
    "learner": LearnerConfig, "replay": ReplayConfig,
}


def _from_native_json(data: dict) -> ApexConfig:
    cfg = ApexConfig()
    for key, value in data.items():
        if key in _SECTIONS:
            known = {f.name for f in dataclasses.fields(_SECTIONS[key])}
            unknown = set(value) - known
            if unknown:
                raise ValueError(
                    f"config keys in {key} the port does not run: "
                    f"{sorted(unknown)}"
                )
            setattr(cfg, key, _SECTIONS[key](**value))
        elif key in ("network", "seed"):
            setattr(cfg, key, data[key])
        elif key.startswith("_"):
            pass  # "_comment" and friends: documentation, not config
        else:
            raise ValueError(f"config entry the port does not run: {key}")
    return cfg.validate()


def to_dict(cfg: ApexConfig) -> dict:
    return dataclasses.asdict(cfg)
