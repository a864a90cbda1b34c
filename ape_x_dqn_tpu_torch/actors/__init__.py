"""The actor fleet (port of ``ape_x_dqn_tpu/actors``)."""
