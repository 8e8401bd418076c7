"""Distributed pieces of the port: ``sharded_table`` (a table split by
row range over a fleet of row-store shards, in process) and
``resilience`` (the retry policy and circuit breaker of the RPC
clients)."""
