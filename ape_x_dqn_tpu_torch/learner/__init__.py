"""The learner step (port of ``ape_x_dqn_tpu/learner``)."""
