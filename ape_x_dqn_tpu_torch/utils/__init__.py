"""Utilities (port of ``ape_x_dqn_tpu/utils``): metrics."""
