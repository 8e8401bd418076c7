"""Operator registry of the port (counterpart of
``paddle_tpu/core/registry.py``; reference: paddle/fluid/framework/
op_registry.h:197 REGISTER_OPERATOR).

One *emitter* per op type: a function that takes the op's inputs as torch
tensors under the reference's slot names and returns its outputs the same
way::

    def emit(ctx: EmitContext, ins: Dict[slot, List[Tensor]], attrs: Dict)
            -> Dict[slot, List[Tensor]]

(e.g. ``ins["X"][0]``, returns ``{"Out": [y]}``). The port's emitters are
thin adapters onto the port's torch functions (``ops/nn_ops.py``,
``ops/rnn_ops.py``, ``ops/sequence_ops.py``, ``ops/attention_block.py``,
``ops/metric_ops.py``, ``ops/lod_ops.py``, ``ops/beam_ops.py``), which
route CUDA tensors to the hand-written kernels and CPU tensors to their
plain versions (``device.uses_kernel``).
The block runner calls them one by one, eagerly (``core/lowering.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

_SEED_MAX = 2 ** 31 - 1

# the IR's dtype strings as torch dtypes (core/ir.py _VALID_DTYPES)
TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def draw_seed(base: int, *salts: int) -> int:
    """An int32 seed in [0, 2**31 - 1) drawn from a ``torch.Generator``
    seeded by ``base`` and ``salts``: the same arguments give the same seed
    on every device and in every process."""
    mixed = int(base) & 0xFFFF_FFFF_FFFF
    for s in salts:
        mixed = (mixed * 1_000_003 + (int(s) & 0xFFFF_FFFF)) \
            & 0xFFFF_FFFF_FFFF
    g = torch.Generator()
    g.manual_seed(mixed)
    return int(torch.randint(0, _SEED_MAX, (), generator=g))


@dataclass
class EmitContext:
    """Per-op context (``paddle_tpu/core/registry.py`` ``EmitContext``).

    The reference's two ``jax.random`` streams become integer seeds drawn
    by :func:`draw_seed`, both fixed by (base seed, op index, salt), so a
    re-run of the same op sees the same seed:

    - :meth:`key`: program level (``base_seed``, the program's
      ``random_seed`` when non-zero);
    - :meth:`step_key`: per run (``step_base_seed``; a program seed of 0
      draws a new one every step, ``core/lowering.py`` ``build_block_fn``).

    ``jax.random`` bits cannot be reproduced here, so random ops agree with
    the JAX package only where they draw nothing (dropout at p 0 or in test
    mode)."""

    base_seed: int = 0
    step_base_seed: Optional[int] = None
    op_index: int = 0
    is_test: bool = False
    # the enclosing ProgramDesc and the OpDesc being emitted (None for a
    # direct emitter call)
    program: Any = None
    op: Any = None
    # the executor's device: where an emitter creates a tensor from nothing
    device: Optional[torch.device] = None
    # the block runner's recorded forwards of this step, by op index:
    # what a ``__vjp__`` differentiates instead of replaying its forward
    # (``core/lowering.py``, ``ops/grad_ops.py``); None outside a runner
    tape: Optional[Dict[int, Any]] = None

    def key(self, salt: int = 0) -> int:
        return draw_seed(self.base_seed, self.op_index, salt)

    def step_key(self, salt: int = 0) -> int:
        base = (self.step_base_seed if self.step_base_seed is not None
                else self.base_seed)
        return draw_seed(base, self.op_index, salt)


@dataclass
class OpSpec:
    type: str
    emit: Callable
    # ops excluded from autodiff (metrics, rng state...)
    no_grad: bool = False
    # docstring-level reference citation
    ref: str = ""


OPS: Dict[str, OpSpec] = {}


def register_op(op_type: str, *, no_grad: bool = False, ref: str = ""):
    """Register an emitter for ``op_type`` (``register_op``,
    ``paddle_tpu/core/registry.py:100``)."""

    def deco(fn: Callable) -> Callable:
        if op_type in OPS:
            raise ValueError(f"op {op_type!r} registered twice")
        OPS[op_type] = OpSpec(type=op_type, emit=fn, no_grad=no_grad,
                              ref=ref)
        return fn

    return deco


def get_op(op_type: str) -> OpSpec:
    spec = OPS.get(op_type)
    if spec is None:
        raise KeyError(
            f"no emitter registered for op {op_type!r}; registered: "
            f"{sorted(OPS)[:40]}...")
    return spec


def has_op(op_type: str) -> bool:
    return op_type in OPS


# -- helpers for emitters ---------------------------------------------------

def first(ins: Dict[str, List[Any]], slot: str, default=None):
    vals = ins.get(slot) or []
    return vals[0] if vals else default


def single(x) -> Dict[str, List[Any]]:
    return {"Out": [x]}
