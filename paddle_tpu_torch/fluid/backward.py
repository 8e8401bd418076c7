"""``append_backward`` of the program builder (counterpart of
``paddle_tpu/fluid/backward.py``; reference:
python/paddle/fluid/backward.py:394): the reverse walk is
``ops/grad_ops.py`` ``append_backward_desc``; this resolves the
parameters and returns their (param, grad) variable pairs."""

from __future__ import annotations

from typing import List, Optional, Tuple

from paddle_tpu_torch.fluid import framework
from paddle_tpu_torch.ops.grad_ops import append_backward_desc


def append_backward(loss, parameter_list: Optional[List[str]] = None,
                    no_grad_set=None, callbacks=None
                    ) -> List[Tuple[framework.Variable, framework.Variable]]:
    program = loss.block.program
    grad_map = append_backward_desc(program.desc.global_block, loss.name,
                                    no_grad_set)
    program.desc.bump_version()

    gblock = program.global_block()
    params_grads = []
    for p in gblock.all_parameters():
        if not getattr(p, "trainable", True):
            continue
        if parameter_list is not None and p.name not in parameter_list:
            continue
        gname = grad_map.get(p.name)
        if gname:
            params_grads.append((p, gblock.var(gname)))
    return params_grads
