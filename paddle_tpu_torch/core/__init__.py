"""The port's program core (counterpart of ``paddle_tpu/core``): the IR
(``ir.py``), the scope (``scope.py``), the op registry (``registry.py``),
the block runner (``lowering.py``) and the executor (``executor.py``).

Nothing is imported here, so that the op modules can register their
emitters (``core/registry.py``) without importing the executor."""
