"""The fleet's discovery plane: run-token-scoped membership for every tier.

Port of ``ape_x_dqn_tpu/fleet/``.  ``registry.py`` holds the registry
(hosted by the trainer under ``fleet.discovery=registry``) and the
member-side client and announcer; both speak the ``F_FANN``/``F_FREP``
kinds of ``runtime/net.py``.  Standard library only.
"""

from ape_x_dqn_tpu_torch.fleet.registry import (  # noqa: F401
    FleetAnnouncer,
    FleetClient,
    FleetRegistry,
    member_doc,
    member_id_for,
)
