"""Serving side of the port: page pool, prompt buckets, slot engine."""
