"""Policy serving: batched Q-network inference on the card, hot reload,
the framed socket plane, and central inference for paramless actors.

Port of ``ape_x_dqn_tpu/serving/`` (the batcher, the server, the socket
front end and central inference):

  * :class:`MicroBatcher` — power-of-two buckets padded by copies of the
    first row, a deadline flush, typed load shedding (``batcher.py``);
  * :class:`PolicyServer` — the batcher over a greedy forward on its own
    high-priority stream, with hot param reload (``server.py``);
  * :class:`ServingNetServer` / :class:`ServingClient` — the CRC-framed
    request/reply plane (``net_server.py``);
  * :class:`CentralInferenceClient` / :class:`CentralSelector` (+ the
    typed :class:`InferenceUnavailable`) — paramless actors
    (``central.py``);
  * :class:`ServingRouter` / :class:`ReplicaProcess` / :class:`ServingFleet`
    — the health-aware router, a replica child and N replicas behind one
    router with their param hub (``router.py``; ``serve --replicas``);
  * typed errors: :class:`ServingError`, :class:`ServerOverloaded`,
    :class:`ServerClosed`.

``sources.py`` holds the param sources a server reads from: a checkpoint
root (``serve --checkpoint``), a param hub's socket (``--param-hub``, what
a fleet's replica runs) and a param tail (``--param-tail``).
``server.py`` and ``sources.py`` import torch; the other modules import
only the standard library and numpy, so this package imports ``server``
lazily.
"""

from ape_x_dqn_tpu_torch.serving.batcher import (
    MicroBatcher,
    ServedAction,
    ServerClosed,
    ServerOverloaded,
    ServingError,
    bucket_for,
    bucket_sizes,
)
from ape_x_dqn_tpu_torch.serving.central import (
    CentralInferenceClient,
    CentralSelector,
    InferenceUnavailable,
    aggregate_inference_stats,
    split_groups,
)
from ape_x_dqn_tpu_torch.serving.net_server import ServingClient, ServingNetServer
from ape_x_dqn_tpu_torch.serving.router import ReplicaProcess, ServingFleet, ServingRouter

__all__ = [
    "CentralInferenceClient",
    "CentralSelector",
    "InferenceUnavailable",
    "MicroBatcher",
    "PolicyServer",
    "ReplicaProcess",
    "ServedAction",
    "ServerClosed",
    "ServerOverloaded",
    "ServingClient",
    "ServingError",
    "ServingFleet",
    "ServingNetServer",
    "ServingRouter",
    "aggregate_inference_stats",
    "bucket_for",
    "bucket_sizes",
    "split_groups",
]


def __getattr__(name):
    if name == "PolicyServer":
        from ape_x_dqn_tpu_torch.serving.server import PolicyServer

        return PolicyServer
    raise AttributeError(name)
