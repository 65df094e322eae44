"""Serving: the batched ServeEngine with a checkpointable session, the
multi-session plane (sessions.py) and its seeded traffic (traffic.py)."""
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.sessions import SessionManager, UserSession
from repro_torch.serving.traffic import Request, TrafficGenerator

__all__ = ["ServeEngine", "SessionManager", "UserSession", "Request",
           "TrafficGenerator"]
