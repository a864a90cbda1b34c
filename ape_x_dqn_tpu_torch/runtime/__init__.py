"""Runtimes (port of ``ape_x_dqn_tpu/runtime``): the device-replay fused
learner, the thread-actor async pipeline, and their component wiring."""
