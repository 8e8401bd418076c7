"""``paddle_tpu_torch.fluid``: the saved-program surface of the port
(counterpart of ``paddle_tpu/fluid``): :class:`Executor` over
:class:`CPUPlace` / :class:`CUDAPlace`, the scope (:class:`Scope`,
:func:`global_scope`, :func:`scope_guard`), :mod:`io` and the slim
:class:`Program` that ``io.load_inference_model`` returns.

    import paddle_tpu_torch.fluid as fluid
    exe = fluid.Executor(fluid.CUDAPlace(0))     # CPUPlace() on the CPU
    prog, feeds, fetches = fluid.io.load_inference_model(dirname, exe)
    out = exe.run(prog, feed={...}, fetch_list=fetches)

The layers and the program-building API are ROADMAP A6.4."""

import contextlib as _contextlib

from paddle_tpu_torch.core.executor import (CPUPlace, CUDAPlace,
                                            EOFException, Executor, Place)
from paddle_tpu_torch.core.scope import Scope, global_scope
from paddle_tpu_torch.fluid import io  # noqa: F401
from paddle_tpu_torch.fluid.framework import Program

__all__ = ["Executor", "Place", "CPUPlace", "CUDAPlace", "Scope",
           "global_scope", "scope_guard", "io", "EOFException", "Program"]


@_contextlib.contextmanager
def scope_guard(scope):
    """reference: executor.py scope_guard — run ``exe.run`` against
    ``scope`` as the global scope."""
    from paddle_tpu_torch.core.scope import _switch_scope
    old = _switch_scope(scope)
    try:
        yield
    finally:
        _switch_scope(old)
