"""The experience transport — the seam between the process-actor pool and
what carries its CRC-framed APXT record stream.

Port of ``ape_x_dqn_tpu/runtime/transport.py``.  Two backends
(``actor.transport``):

  * ``shm`` (the default) — one SIGKILL-safe ``ShmRing`` per worker
    incarnation, created learner-side and attached by segment name
    worker-side; params ride the pool's shared-memory seqlock buffer.
  * ``tcp`` (``runtime/net.py``) — the same framed records over one
    nonblocking socket per worker incarnation, drained under a bounded
    per-connection budget (``config.transport_budget``'s arithmetic), torn
    frames counted like a torn ring tail, reconnects with backoff on the
    worker side.  Params ride the same connection in reverse as
    delta-or-full frames (``NetParamStore`` / ``NetParamSource``), so each
    push's cost is measured.

Both sides of the seam keep the ring's reader and writer surface
(``read_next`` / ``torn_tail`` / ``committed`` / ``write``), so the pool's
poll, salvage and stats paths do not know which backend runs.

stdlib + numpy only at module scope: worker children import this before
torch.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from ape_x_dqn_tpu_torch.runtime.net import NetTransport, NetWriter
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

    def pump(self) -> None:  # nothing to accept
        pass

    def drop_channel(self, wid: int, channel) -> None:  # no registry
        pass

    def stats(self) -> dict:
        return {}

    def close(self) -> None:
        pass


class TcpTransport:
    """The learner-side ``NetTransport`` (listener, one channel per worker
    incarnation, param fan-out).  The wire-efficiency knobs (coalesced
    ``F_XPB`` frames, in-window frame dedup, the negotiated codec) ride the
    endpoint spec to each worker's ``NetWriter``; with all of them off the
    wire is the v1 format."""

    kind = "tcp"

    def __init__(self, host: str, port: int, drain_budget_per_conn: int,
                 conn_buf_bytes: int, codec: str = "off",
                 coalesce_bytes: int = 0, coalesce_wait_ms: float = 20.0,
                 dedup: bool = True):
        # A listener that cannot bind raises here: there is no fallback to
        # the shm rings.
        self.net = NetTransport(host=host, port=port,
                                drain_budget_per_conn=drain_budget_per_conn,
                                conn_buf_bytes=conn_buf_bytes, codec=codec)
        self._codec = str(codec)
        self._coalesce = int(coalesce_bytes)
        self._coal_wait_ms = float(coalesce_wait_ms)
        self._dedup = bool(dedup)

    @property
    def port(self) -> int:
        return self.net.port

    def make_channel(self, wid: int, attempt: int):
        return self.net.make_channel(wid, attempt)

    def endpoint(self, channel, wid: int, attempt: int) -> dict:
        # Workers dial the learner back; a listener bound to every address
        # cannot be dialed literally, so a local spawn gets loopback (a
        # remote host overrides the address: host_join --host).
        host = self.net.host
        if host in ("0.0.0.0", "::"):
            host = "127.0.0.1"
        return {"kind": "tcp", "host": host, "port": self.net.port,
                "token": self.net.token, "wid": int(wid), "attempt": int(attempt),
                "codec": self._codec, "coalesce": self._coalesce,
                "coalesce_wait_ms": self._coal_wait_ms, "dedup": self._dedup}

    def pump(self) -> None:
        self.net.pump()

    def drop_channel(self, wid: int, channel) -> None:
        self.net.drop_channel(wid, channel)

    def stats(self) -> dict:
        return self.net.stats()

    def close(self) -> None:
        self.net.close()


def make_transport(cfg, num_workers: int, ring_bytes: int, drain_budget_bytes: int):
    """The backend ``actor.transport`` names.  A tcp connection's drain
    bound is the poll sweep's byte budget split across the fleet, floored
    at 64 KiB (``config.transport_budget``'s ``conn_drain_budget_bytes``)."""
    a = cfg.actor
    if a.transport == "shm":
        return ShmTransport(ring_bytes)
    if a.transport == "tcp":
        per_conn = max(64 << 10, int(drain_budget_bytes) // max(1, int(num_workers)))
        return TcpTransport(host=a.transport_host, port=a.transport_port,
                            drain_budget_per_conn=per_conn,
                            conn_buf_bytes=a.net_conn_buf_bytes, codec=a.net_codec,
                            coalesce_bytes=a.net_coalesce_bytes,
                            coalesce_wait_ms=a.net_coalesce_wait_ms, dedup=a.net_dedup)
    raise ValueError(f"unknown actor.transport: {a.transport}")


def connect_channel(spec: dict):
    """Worker-side attach: the writer end of a learner endpoint spec — a
    name-attached ShmRing or a reconnecting NetWriter, both with
    ``write(parts, should_stop, ...)``."""
    if spec["kind"] == "shm":
        return ShmRing(spec["capacity"], name=spec["name"], create=False)
    if spec["kind"] == "tcp":
        return NetWriter(spec)
    raise ValueError(f"unknown transport endpoint kind: {spec['kind']}")


class NetParamStore:
    """The learner's param store over the tcp transport: the surface of
    ``runtime/param_store.ParamStore`` (``publish`` / ``get`` /
    ``get_blocking`` / ``version``).  Each publish copies the params to the
    host, serializes them once (``utils/serialization.tree_to_bytes``,
    whose APXT layout puts every leaf at the same offset in every version,
    so a publish that moves few pages ships a small delta) and fans the
    snapshot out as delta-or-full frames; the push's cost lands in the
    transport's ``net`` stats."""

    def __init__(self, transport: TcpTransport):
        self._net = transport.net
        self._lock = threading.Lock()
        self._params = None   # host copy for in-process readers
        self._version = 0

    @property
    def version(self) -> int:
        return self._version

    def publish(self, params: dict) -> int:
        from ape_x_dqn_tpu_torch.actors.pool import host_params
        from ape_x_dqn_tpu_torch.utils.serialization import tree_to_bytes

        host = host_params(params)
        payload = tree_to_bytes(host)
        with self._lock:
            self._params = host
            self._version += 1
            self._net.set_params(payload, self._version)
            return self._version

    def get(self, have_version: int = -1):
        with self._lock:
            if self._params is None or self._version <= have_version:
                return None
            return self._params, self._version

    def get_blocking(self, timeout: float = 30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            got = self.get(-1)
            if got is not None:
                return got
            time.sleep(0.01)
        raise TimeoutError("no parameters published within timeout")


class NetParamSource:
    """Worker-side param source over the experience connection: pump the
    incoming full and delta frames, and restore into the worker's template
    on a new version (``ActorFleet.sync_params``'s contract)."""

    def __init__(self, writer: NetWriter, template: Any):
        self._writer = writer
        self._template = template

    def get(self, have_version: int = -1):
        self._writer.pump_params()
        got = self._writer.latest_params()
        if got is None:
            return None
        payload, version = got
        if version <= have_version:
            return None
        from ape_x_dqn_tpu_torch.utils.serialization import restore_like

        return restore_like(self._template, payload), version
