"""Unique name generator of the port (its own copy of
``paddle_tpu/fluid/unique_name.py``; reference:
python/paddle/fluid/unique_name.py): per-key counters, and a ``guard()``
that gives a block a fresh generator. Every layer names its parameters
and temporaries through it, so a build under a fresh guard names them as
the JAX package's build under a fresh guard does."""

from __future__ import annotations

import contextlib
from collections import defaultdict


class NameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        i = self.ids[key]
        self.ids[key] += 1
        return "_".join(x for x in (self.prefix, key, str(i)) if x != "")


_generator = NameGenerator()


def generate(key: str) -> str:
    return _generator(key)


@contextlib.contextmanager
def guard(new_prefix: str = ""):
    global _generator
    old = _generator
    _generator = NameGenerator(new_prefix)
    try:
        yield
    finally:
        _generator = old


def switch(new_generator=None):
    """Swap the global generator and return the previous one (``guard()``
    composes this)."""
    global _generator
    old = _generator
    _generator = new_generator or NameGenerator()
    return old
