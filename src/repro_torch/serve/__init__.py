"""Continuous-batching serve engine of the port and its replicated tier.

  session.py — Request / Session / synthetic traces,
  pools.py   — SlotPool / BlockPool host bookkeeping,
  prefix.py  — PrefixIndex content-addressed prefix cache,
  stats.py   — EngineStats / ServeReport,
  engine.py  — ServeEngine (paged or dense, greedy or sampled, session
               export / import),
  router.py  — Router / RouterReport / IntegrityScrubber: replicas, live
               migration, the kill drill.
"""

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.pools import BlockPool, SlotPool
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.router import IntegrityScrubber, Router, RouterReport
from repro_torch.serve.session import Request, Session, synthetic_trace
from repro_torch.serve.stats import EngineStats, ServeReport

__all__ = ["BlockPool", "EngineStats", "IntegrityScrubber", "PrefixIndex",
           "Request", "Router", "RouterReport", "ServeEngine", "ServeReport",
           "Session", "SlotPool", "synthetic_trace"]
