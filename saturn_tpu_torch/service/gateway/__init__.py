"""The service's network front door: JSONL over TCP.

Counterpart of ``saturn_tpu/service/gateway/``:

- :mod:`protocol`: frames, typed wire errors, the exception mapping;
- :mod:`server`: :class:`GatewayServer`, a threaded front door with
  idempotent submission, per-request deadlines, inflight windows, replicas
  and graceful drain;
- :mod:`client`: :class:`GatewayClient`, a retrying client with
  ``ServiceClient``'s surface.

``resilience/netchaos.py`` attacks the wire between them.
"""

from saturn_tpu_torch.service.gateway.client import GatewayClient
from saturn_tpu_torch.service.gateway.protocol import (ERROR_CODES, RETRIABLE_CODES,
                                                       GatewayError, classify_exception)
from saturn_tpu_torch.service.gateway.server import GatewayServer

__all__ = [
    "ERROR_CODES",
    "GatewayClient",
    "GatewayError",
    "GatewayServer",
    "RETRIABLE_CODES",
    "classify_exception",
]
