"""Continuous-batching serve engine of the port (paged layout, greedy).

  session.py — Request / Session / synthetic traces,
  pools.py   — SlotPool / BlockPool host bookkeeping,
  prefix.py  — PrefixIndex content-addressed prefix cache,
  stats.py   — EngineStats / ServeReport,
  engine.py  — ServeEngine.
"""

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.pools import BlockPool, SlotPool
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.session import Request, Session, synthetic_trace
from repro_torch.serve.stats import EngineStats, ServeReport

__all__ = ["BlockPool", "EngineStats", "PrefixIndex", "Request",
           "ServeEngine", "ServeReport", "Session", "SlotPool",
           "synthetic_trace"]
