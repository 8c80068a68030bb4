"""Secure federated inference serving on PyTorch.

:class:`ServeEngine` coalesces concurrent requests into rank-k forward
dispatches through the engine's masked-aggregation boundary and caches
aggregated passive partials per sample id; :class:`ServeQueue` wraps it in
a ``max_batch``/``max_wait`` continuous-batching admission loop.
"""
from repro_torch.serve.engine import ServeEngine, ServeStats
from repro_torch.serve.queue import ServeQueue

__all__ = ["ServeEngine", "ServeStats", "ServeQueue"]
