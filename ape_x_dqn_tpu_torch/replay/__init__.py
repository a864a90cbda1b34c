"""Replay (port of ``ape_x_dqn_tpu/replay``): the device-resident ring."""
