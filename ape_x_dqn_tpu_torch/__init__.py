"""ape_x_dqn_tpu_torch — the PyTorch/CUDA port of ``ape_x_dqn_tpu``.

The package mirrors the JAX package module by module, so each file here has
a counterpart of the same path under ``ape_x_dqn_tpu/``.  It imports
``torch`` and never ``jax``, ``flax``, ``optax`` or any module of the JAX
package: what it needs of the JAX package's jax-free host code (config,
envs) it carries as its own copy.

The port so far covers the device-replay learner
(``learner.device_replay=true``): an actor-fleet thread feeds a fused
learner that runs K × [prioritized sample → double-Q train → priority
restamp] per call, with the stratified inverse-CDF sampler as a CUDA kernel
written for Hopper (``ops/csrc/sampling.cu``).  Entry point:
``python -m ape_x_dqn_tpu_torch.train --set learner.device_replay=true``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; a missing card or a kernel that fails to build raises.
"""

__version__ = "0.1.0"
