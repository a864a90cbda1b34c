"""Q-networks (port of ``ape_x_dqn_tpu/models``)."""
