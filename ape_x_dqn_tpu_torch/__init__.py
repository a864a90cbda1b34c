"""ape_x_dqn_tpu_torch — the PyTorch/CUDA port of ``ape_x_dqn_tpu``.

The package mirrors the JAX package module by module, so each file here has
a counterpart of the same path under ``ape_x_dqn_tpu/``.  It imports
``torch`` and never ``jax``, ``flax``, ``optax`` or any module of the JAX
package: what it needs of the JAX package's jax-free host code (config,
envs) it carries as its own copy.

The port so far covers both forms of the learner:
  * the host-replay golden path (``learner.device_replay=false``, the
    default): a numpy prioritized replay over a float64 sum-tree (C++ core
    built with g++ at first use), a prefetch thread that copies sampled
    batches to the device, one train step per batch with deferred priority
    write-back — async (``AsyncPipeline``) or single-process
    (``SingleProcessDriver``, ``--mode sync``); with ``replay.dedup=true``
    the frame-dedup ``DedupReplay`` (C++ twin: ``native_dedup.py``), and
    with ``replay.hot_frame_budget_bytes`` its frames tiered over a spill
    file (``replay/tiered.py``);
  * the device-replay learner (``learner.device_replay=true``): an
    actor-fleet thread feeds a fused learner that runs K × [prioritized
    sample → double-Q train → priority restamp] per call, with the
    stratified inverse-CDF sampler as a CUDA kernel written for Hopper
    (``ops/csrc/sampling.cu``); with ``replay.dedup=true`` the ring stores
    each frame once (``replay/device_dedup.py``, ``runtime/fused_dedup.py``).
Actors run as a thread or as CPU-only worker processes (``actor.mode``).
Entry point: ``python -m ape_x_dqn_tpu_torch.train [--mode async|sync]``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; a missing card or a kernel that fails to build raises.
"""

__version__ = "0.1.0"
