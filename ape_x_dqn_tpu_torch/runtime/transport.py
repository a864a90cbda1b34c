"""The experience transport — the seam between the process-actor pool and
what carries its CRC-framed APXT record stream.

Port of the ``shm`` backend of ``ape_x_dqn_tpu/runtime/transport.py``: one
``ShmRing`` per worker incarnation, created learner-side and attached by
segment name worker-side; params ride the pool's shared-memory seqlock
buffer.  The JAX package's ``tcp`` backend (``runtime/net.py``:
``TcpTransport``, ``NetParamStore``, ``NetParamSource``) is not part of the
port yet; ``actor.transport=tcp`` fails config validation.

stdlib + numpy only: worker children import this before torch.
"""

from __future__ import annotations

from ape_x_dqn_tpu_torch.runtime.shm_ring import ShmRing


class ShmTransport:
    """One ShmRing per worker incarnation, created learner-side, attached
    by name worker-side."""

    kind = "shm"

    def __init__(self, ring_bytes: int):
        self._ring_bytes = int(ring_bytes)

    def make_channel(self, wid: int, attempt: int) -> ShmRing:
        return ShmRing(self._ring_bytes)

    def endpoint(self, channel: ShmRing, wid: int, attempt: int) -> dict:
        return {"kind": "shm", "name": channel.name, "capacity": self._ring_bytes}


def make_transport(cfg) -> ShmTransport:
    """The backend ``actor.transport`` names (``shm`` only in the port)."""
    kind = cfg.actor.transport
    if kind == "shm":
        return ShmTransport(cfg.actor.xp_ring_bytes)
    raise ValueError(f"actor.transport={kind}: only the shm transport is part of "
                     "the port (runtime/net.py is not ported yet)")


def connect_channel(spec: dict) -> ShmRing:
    """Worker-side attach: the writer end of a learner endpoint spec."""
    if spec["kind"] == "shm":
        return ShmRing(spec["capacity"], name=spec["name"], create=False)
    raise ValueError(f"unknown transport endpoint kind: {spec['kind']}")
