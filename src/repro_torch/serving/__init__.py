"""Serving: the batched ServeEngine with a checkpointable session. The
multi-session plane (sessions.py) and traffic.py are not ported yet."""
from repro_torch.serving.engine import ServeEngine

__all__ = ["ServeEngine"]
