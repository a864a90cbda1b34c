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
  * typed errors: :class:`ServingError`, :class:`ServerOverloaded`,
    :class:`ServerClosed`.

``sources.CheckpointParamSource`` serves a checkpoint root (``serve
--checkpoint``).  The router and replica fleet, the param hub and the
param tail (``router.py``, the rest of ``sources.py``) are not part of the
port yet (ROADMAP item 1).  ``server.py`` and ``sources.py`` import torch;
the other modules import only the standard library and numpy, so this
package imports ``server`` lazily.
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

__all__ = [
    "CentralInferenceClient",
    "CentralSelector",
    "InferenceUnavailable",
    "MicroBatcher",
    "PolicyServer",
    "ServedAction",
    "ServerClosed",
    "ServerOverloaded",
    "ServingClient",
    "ServingError",
    "ServingNetServer",
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
