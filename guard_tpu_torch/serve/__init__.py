"""The concurrent serving plane of the port: multi-client connection
handling (`server.py`: multiplexed stdio ids, threaded TCP/HTTP
listener), traffic discipline (`frontdoor.py`: tenant quotas, the SLO
circuit breaker) and cross-request batch coalescing (`batcher.py`: one
packed dispatch on the card per rule digest instead of one per
request)."""

from .batcher import BatchTimeout, CoalescingBatcher
from .server import ServeServer

__all__ = [
    "BatchTimeout",
    "CoalescingBatcher",
    "ServeServer",
]
