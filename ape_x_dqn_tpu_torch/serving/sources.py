"""Param sources beyond the live ``ParamStore``: a checkpoint root, the
param hub's socket and the param tail.

Port of ``ape_x_dqn_tpu/serving/sources.py``.  The serving tier polls the
same ``get(have_version) -> (params, version)`` protocol the actor fleets
do, so "attach to a live trainer", "watch a checkpoint dir", "subscribe to
a param hub" and "tail a chain of param files" are one server with another
source.  The ``PolicyServer``'s reload uploads what a source returns to
fresh device tensors on its copy stream.

  * ``CheckpointParamSource`` (JAX :37-68) — version = the newest committed
    step (``utils/checkpoint.latest_step``: the state leg lands last, so a
    half-written step is never visible); only the params subtree of its
    state leg is read.
  * ``SocketParamSource`` (JAX :84-121) — a replica's subscription to a
    param hub (any ``runtime/net.NetTransport`` that publishes with
    ``set_params``): the ``NetWriter`` + ``NetParamSource`` pair of the
    tcp workers, full snapshot on connect, page-deltas after, crc-checked
    patches, reconnect and full resync on any fault.
  * ``ParamTailWriter`` / ``ParamTailSource`` (JAX :124-309) — the same
    delta-or-full payloads committed as APXC chunk files
    (``utils/checkpoint_inc.write_chunk``: tmp + fsync + rename, a torn
    file typed ``ChunkCorrupt`` and never decoded); a reader extends its
    held snapshot by consecutive deltas, and a corrupt rung walks back to
    the newest intact full.

A source returns the params as CPU tensors shaped like its template's.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ape_x_dqn_tpu_torch.utils.checkpoint import latest_step, read_state_leg


class CheckpointParamSource:
    """A param source over a checkpoint root; version = training step.
    ``template`` (the network's params, e.g. ``build_components``' state)
    gives the names, shapes and dtypes each read is checked against."""

    def __init__(self, root: str, template: dict):
        self.root = root
        self._template = {k: (tuple(v.shape), v.dtype) for k, v in template.items()}

    @property
    def version(self) -> int:
        """Newest committed step (-1 when there is none)."""
        step = latest_step(self.root)
        return -1 if step is None else int(step)

    def get(self, have_version: int = -1) -> Optional[Tuple[Any, int]]:
        step = latest_step(self.root)
        if step is None or step <= have_version:
            return None
        # A newer step may commit between the probe and the read; the read
        # names the step it resolved, so the version stays exact.
        tree = read_state_leg(os.path.join(self.root, f"step_{step}"), subtree="params")
        params = {}
        for k, (shape, dtype) in self._template.items():
            v = tree[k]
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"checkpoint param {k}: {t.dtype}{tuple(t.shape)} != "
                                 f"the served network's {dtype}{shape}")
            params[k] = t
        if set(tree) != set(self._template):
            raise ValueError(f"checkpoint params {sorted(tree)} != the served "
                             f"network's {sorted(self._template)}")
        return params, int(step)


def _host_template(template: dict) -> dict:
    """Names, shapes and dtypes of ``template`` as uninitialised CPU
    tensors: what ``restore_like`` checks a snapshot against, without a
    copy of a device template per poll."""
    return {k: torch.empty(tuple(v.shape), dtype=v.dtype) for k, v in template.items()}


def parse_hub_spec(spec: str) -> dict:
    """``host:port:token:wid:attempt`` → a ``runtime/net.NetWriter`` spec."""
    parts = spec.rsplit(":", 4)
    if len(parts) != 5:
        raise ValueError(f"param hub spec {spec!r} is not host:port:token:wid:attempt")
    host, port, token, wid, attempt = parts
    return {"host": host, "port": int(port), "token": int(token), "wid": int(wid),
            "attempt": int(attempt)}


class SocketParamSource:
    """A replica's param source over a param-hub connection: the tcp
    workers' ``NetWriter`` param pump and ``NetParamSource`` restore, with
    no experience written.  The hub must hold a channel for ``wid`` at
    ``attempt`` and the run's token."""

    def __init__(self, spec, template: dict):
        from ape_x_dqn_tpu_torch.runtime.net import NetWriter
        from ape_x_dqn_tpu_torch.runtime.transport import NetParamSource

        if isinstance(spec, str):
            spec = parse_hub_spec(spec)
        self._writer = NetWriter(spec)
        self._inner = NetParamSource(self._writer, _host_template(template))

    @property
    def version(self) -> int:
        """Newest version received (-1 before the first full snapshot)."""
        return int(self._writer._param_version)

    @property
    def connected(self) -> bool:
        return self._writer._sock is not None

    def get(self, have_version: int = -1):
        return self._inner.get(have_version)

    def close(self) -> None:
        self._writer.close()


_TAIL_RE = re.compile(r"^pp_(\d{10})_(full|delta)\.apxc$")


def _tail_name(version: int, kind: str) -> str:
    return f"pp_{int(version):010d}_{kind}.apxc"


class ParamTailWriter:
    """Publish params as a chain of APXC chunk files, the JAX package's
    names and arrays (``version``, ``base``, ``payload``): a full snapshot
    every ``base_every`` publishes (or whenever a delta is impossible or not
    worth it), page-deltas against the previous version in between.
    Pruning keeps the current full's chain and the previous full's, so a
    reader mid-walk never loses its rung."""

    def __init__(self, root: str, *, base_every: int = 16):
        if base_every < 1:
            raise ValueError("base_every must be >= 1")
        self.root = root
        self._base_every = int(base_every)
        os.makedirs(root, exist_ok=True)
        self._prev_payload: Optional[bytes] = None
        self._version = 0
        self._last_full = 0
        self._prev_full = 0
        self.full_writes = 0
        self.delta_writes = 0
        self.bytes_written = 0

    @property
    def version(self) -> int:
        return self._version

    def publish_payload(self, payload: bytes) -> str:
        """Commit one serialized snapshot; returns the path written."""
        from ape_x_dqn_tpu_torch.runtime.net import build_param_delta
        from ape_x_dqn_tpu_torch.utils.checkpoint_inc import write_chunk

        self._version += 1
        v = self._version
        delta = None
        if self._prev_payload is not None and (v - self._last_full) < self._base_every:
            delta = build_param_delta(v, v - 1, self._prev_payload, payload)
        if delta is None:
            kind, body, base = "full", payload, -1
            self._prev_full, self._last_full = self._last_full, v
            self.full_writes += 1
        else:
            kind, body, base = "delta", delta, v - 1
            self.delta_writes += 1
        path = os.path.join(self.root, _tail_name(v, kind))
        self.bytes_written += write_chunk(path, {
            "version": np.int64(v),
            "base": np.int64(base),
            "payload": np.frombuffer(body, dtype=np.uint8),
        })
        self._prev_payload = payload
        self._prune()
        return path

    def publish(self, params: dict) -> str:
        """Serialize ``params`` (tensors on any device) and commit them."""
        from ape_x_dqn_tpu_torch.actors.pool import host_params
        from ape_x_dqn_tpu_torch.utils.serialization import tree_to_bytes

        return self.publish_payload(tree_to_bytes(host_params(params)))

    def _prune(self) -> None:
        """Drop the files older than the previous full's chain."""
        floor = self._prev_full if self._prev_full > 0 else self._last_full
        for name in os.listdir(self.root):
            m = _TAIL_RE.match(name)
            if m and int(m.group(1)) < floor:
                try:
                    os.unlink(os.path.join(self.root, name))
                except OSError:
                    pass


class ParamTailSource:
    """A param source tailing a ``ParamTailWriter`` chain: ``get`` extends
    the held snapshot by consecutive deltas, else restores the newest
    intact full and its deltas.  A rung that fails its crc or decode
    (``ChunkCorrupt``) or whose base or patch mismatches ends that chain,
    and the walk falls back to an older full: corrupt bytes never restore
    (counted in ``corrupt_skips``)."""

    def __init__(self, root: str, template: dict):
        self.root = root
        self._template = _host_template(template)
        self._payload: Optional[bytes] = None
        self._version = -1
        self.corrupt_skips = 0

    def _scan(self):
        """Sorted [(version, kind, path)] of the chain's files."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        out = []
        for name in names:
            m = _TAIL_RE.match(name)
            if m:
                out.append((int(m.group(1)), m.group(2), os.path.join(self.root, name)))
        out.sort()
        return out

    @property
    def version(self) -> int:
        entries = self._scan()
        return entries[-1][0] if entries else -1

    def _read(self, path: str) -> Tuple[int, int, bytes]:
        from ape_x_dqn_tpu_torch.utils.checkpoint_inc import read_chunk

        arrays = read_chunk(path)
        return int(arrays["version"]), int(arrays["base"]), arrays["payload"].tobytes()

    def _apply_deltas(self, payload: bytes, version: int, entries) -> Tuple[bytes, int]:
        """Consecutive delta rungs from ``version`` + 1 on; stops at a gap, a
        full, or a corrupt or mismatched rung."""
        from ape_x_dqn_tpu_torch.runtime.net import apply_param_delta
        from ape_x_dqn_tpu_torch.utils.checkpoint_inc import ChunkCorrupt

        by_version = {v: (kind, path) for v, kind, path in entries}
        while True:
            nxt = by_version.get(version + 1)
            if nxt is None or nxt[0] != "delta":
                return payload, version
            try:
                v, base, body = self._read(nxt[1])
                if base != version:
                    raise ValueError(f"delta base {base} != held version {version}")
                _, _, payload = apply_param_delta(payload, body)
            except (ChunkCorrupt, ValueError):
                self.corrupt_skips += 1
                return payload, version
            version = v

    def get(self, have_version: int = -1):
        from ape_x_dqn_tpu_torch.utils.checkpoint_inc import ChunkCorrupt
        from ape_x_dqn_tpu_torch.utils.serialization import restore_like

        entries = self._scan()
        if not entries:
            return None
        if self._payload is not None:
            payload, version = self._apply_deltas(self._payload, self._version, entries)
            if version > self._version:
                self._payload, self._version = payload, version
        best = (self._payload, self._version)
        if best[1] < entries[-1][0]:
            # A full newer than the deltas reach (or nothing held): walk the
            # fulls newest first until one chain restores.
            fulls = [e for e in entries if e[1] == "full"]
            for v, _kind, path in reversed(fulls):
                if v <= best[1]:
                    break
                try:
                    _, _, payload = self._read(path)
                except ChunkCorrupt:
                    self.corrupt_skips += 1
                    continue
                payload, version = self._apply_deltas(payload, v, entries)
                if version > best[1]:
                    best = (payload, version)
                    self._payload, self._version = payload, version
                break
        if best[0] is None or best[1] <= int(have_version):
            return None
        return restore_like(self._template, best[0]), best[1]
