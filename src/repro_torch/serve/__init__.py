"""Serving (port of ``repro/serve``): continuous batching over a paged KV
cache, with K8 (``kernels/paged_decode.py``) as the decode kernel and
optional int8 KV.

  scheduler.py  slot protocol, page allocation, ServeConfig / SlotState,
                the HostLedger admission mirror
  engine.py     the admit and decode steps and the host serving loop
"""
from repro_torch.serve.engine import (ServeEngine, init_paged_cache,
                                      kv_bytes_read)
from repro_torch.serve.scheduler import (HostLedger, Request, ServeConfig,
                                         SlotState)

__all__ = ["ServeEngine", "ServeConfig", "SlotState", "Request",
           "HostLedger", "init_paged_cache", "kv_bytes_read"]
