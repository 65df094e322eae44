"""Sharding rules and mesh records of the port (``distributed/sharding.py``)."""
