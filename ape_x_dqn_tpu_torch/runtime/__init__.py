"""Runtimes (port of ``ape_x_dqn_tpu/runtime``): the single-process
driver, the thread-actor async pipeline (host replay with prefetch infeed,
or the device-replay fused learner), and their component wiring."""
