"""Sharding rules of the port (``rules``)."""
