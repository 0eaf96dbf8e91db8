"""Optimizers of the port (AdamW with optional int8 moments)."""
