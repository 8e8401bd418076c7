"""Utilities of the port: ``faults`` (deterministic fault injection)."""
