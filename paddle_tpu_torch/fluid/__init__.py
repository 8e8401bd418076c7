"""``paddle_tpu_torch.fluid``: the program surface of the port
(counterpart of ``paddle_tpu/fluid``): the program builder
(:class:`Program`, :func:`program_guard`, ``layers``, ``nets``,
``initializer``, :class:`ParamAttr`, ``backward``, ``optimizer``,
``regularizer``, ``clip``, ``learning_rate_scheduler``, ``unique_name``),
:class:`Executor` over :class:`CPUPlace` / :class:`CUDAPlace`, the scope
(:class:`Scope`, :func:`global_scope`, :func:`scope_guard`) and ``io``.

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.models import transformer
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, feeds = transformer.build(fused_attention=True,
                                           fused_head=True)
    exe = fluid.Executor()                  # CUDAPlace(0); CPUPlace() too
    exe.run(startup)
    exe.run(main, feed=batch, fetch_list=[loss])

``fluid.models`` holds the bench builders (mnist, the stacked LSTM, the
Transformer, the six image classifiers, deepfm and machine translation,
whose ``build(is_train=False)`` is the beam decoder). A saved model runs
the same way:
``prog, feeds, fetches = fluid.io.load_inference_model(dirname, exe)``.
What the JAX package's ``fluid`` has beyond this (``compiler``,
``data_feeder``, ``evaluator``, ``metrics``, ``profiler``, ``transpiler``,
``batch_merge``, ``WeightNormParamAttr``) is ROADMAP A6.4b and later."""

import contextlib as _contextlib

from paddle_tpu_torch.core.executor import (CPUPlace, CUDAPlace,
                                            EOFException, Executor, Place)
from paddle_tpu_torch.core.scope import Scope, global_scope
from paddle_tpu_torch.fluid import unique_name  # noqa: F401
from paddle_tpu_torch.fluid import (backward, clip, initializer,  # noqa: F401
                                    layers, nets, optimizer, param_attr,
                                    regularizer)
from paddle_tpu_torch.fluid import io, learning_rate_scheduler  # noqa: F401
from paddle_tpu_torch.fluid.framework import (Program, default_main_program,
                                              default_startup_program,
                                              name_scope, program_guard)
from paddle_tpu_torch.fluid.param_attr import ParamAttr, WeightNormParamAttr

__all__ = ["Executor", "Place", "CPUPlace", "CUDAPlace", "Scope",
           "global_scope", "scope_guard", "io", "EOFException", "Program",
           "default_main_program", "default_startup_program",
           "program_guard", "name_scope", "ParamAttr",
           "WeightNormParamAttr", "backward", "clip", "initializer",
           "layers", "nets", "optimizer", "param_attr", "regularizer",
           "unique_name", "learning_rate_scheduler"]


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
