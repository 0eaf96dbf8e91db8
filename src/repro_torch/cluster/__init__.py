"""Cluster model and the discrete-event simulation engine."""
