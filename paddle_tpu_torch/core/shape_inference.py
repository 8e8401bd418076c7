"""Build-time shape inference of the port (counterpart of
``paddle_tpu/core/shape_inference.py``): the op's own emitter
(``core/registry.py`` ``OPS``) run once over ``torch.device("meta")``
tensors, which carry a shape and a dtype and no data.

Where the JAX file abstractly evaluates the emitter under
``jax.eval_shape`` (``:148``), the port calls it on meta tensors inside
``device.abstract_evaluation()``: the kernel wrappers then take their
plain versions, which on meta tensors compute nothing. The parts are the
JAX file's:

- the dynamic batch dimension (-1 in ``VarDesc.shape``) enters as the
  sentinel prime 6079 and every multiple of it comes back as -1;
- :class:`InferResult`: an op is inferred, or skipped for a benign reason
  (``unregistered-op``, ``missing-input-shape``, ``concrete-value-needed``
  (an emitter that reads values: ``.item()``, ``.tolist()``, numpy, a
  boolean mask), ``needs-program``, ``dynamic-dim-ambiguous``), or it hits
  a genuine emitter error, carried on the result;
- a failure with a dynamic dim is retried at a concrete batch of 4: success
  there means the sentinel made it (``dynamic-dim-ambiguous``);
- an :class:`EmitContext` with base seed 0.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core import ir
# every emitter registers itself when the block runner imports the ops
# (the serving ops of ``ops/kv_attention.py`` among them)
from paddle_tpu_torch.core import lowering as _lowering  # noqa: F401
from paddle_tpu_torch.core.registry import (TORCH_DTYPES, EmitContext,
                                            get_op, has_op)

_SENTINEL = 6079  # prime, unlikely to appear as a real static dim
_META = torch.device("meta")

logger = logging.getLogger("paddle_tpu_torch.shape_inference")

# The JAX package runs with 64-bit types off, so ``jax.eval_shape``
# reports an int64 result as int32 and a float64 one as float32, and its
# ``Block._infer_shapes`` writes that dtype over the declared one (int64
# ``top_k`` indices and ``accuracy`` counts come out int32 in its
# programs). The port's emitters give the wide types; mapping them here,
# in this one place, keeps the two packages' descs equal.
_CANONICAL = {torch.int64: "int32", torch.float64: "float32"}
_DTYPE_NAMES = {v: k for k, v in TORCH_DTYPES.items()}

# what torch raises when an emitter asks a meta tensor for values
# (``.item()`` / ``bool()``, ``.tolist()`` / ``.cpu()``, numpy, and the
# data-dependent ops: ``nonzero``, boolean masks, ``unique``): the benign
# "needs concrete values" case, the counterpart of the JAX file's
# concretization errors. Only these exception types and messages count;
# any other error, whatever it mentions, is the emitter's own.
_CONCRETE_TYPES = (RuntimeError, NotImplementedError, TypeError)
_CONCRETE_MARKS = ("cannot be called on meta tensors",
                   "Cannot copy out of meta tensor",
                   "can't convert meta device type tensor",
                   "data-independent implementation does not exist",
                   "with Meta tensors", "from the 'Meta' backend",
                   "a meta tensor without output_size")


@dataclass(frozen=True)
class InferResult:
    """Outcome of abstractly evaluating one op (``shape_inference.py:61``).

    Exactly one of three states:
    - inferred:       ``outputs`` is the {name: (shape, dtype)} map;
    - skipped:        ``outputs`` is None, ``skipped`` names the benign
                      reason;
    - emitter error:  ``outputs`` is None, ``error`` / ``error_type`` carry
                      the genuine failure.
    """

    outputs: Optional[Dict[str, Tuple[Tuple[int, ...], str]]] = None
    skipped: Optional[str] = None
    error: Optional[str] = None
    error_type: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.outputs is not None


class _MissingShape(Exception):
    pass


def _to_meta(v: ir.VarDesc, batch_dim: int = _SENTINEL) -> torch.Tensor:
    """Declared shape -> meta tensor: -1 becomes ``batch_dim``, and
    sentinel-multiple dims rescale to the same batch base so that a
    concrete-batch retry stays self-consistent."""
    shape = []
    for d in (v.shape or ()):
        if d == -1:
            shape.append(batch_dim)
        elif batch_dim != _SENTINEL and d >= _SENTINEL \
                and d % _SENTINEL == 0:
            shape.append((d // _SENTINEL) * batch_dim)
        else:
            shape.append(d)
    return torch.empty(tuple(shape), dtype=TORCH_DTYPES[v.dtype],
                       device=_META)


def _from_abstract(shape) -> Tuple[int, ...]:
    return tuple(-1 if d >= _SENTINEL and d % _SENTINEL == 0 else int(d)
                 for d in shape)


def _dtype_name(dtype: torch.dtype) -> str:
    return _CANONICAL.get(dtype) or _DTYPE_NAMES[dtype]


def _needs_concrete(e: Exception) -> bool:
    msg = str(e)
    return (isinstance(e, _CONCRETE_TYPES)
            and any(m in msg for m in _CONCRETE_MARKS))


# ops whose emitters lower sub-blocks and need the enclosing ProgramDesc
_NEEDS_PROGRAM = frozenset({"while", "scan", "cond", "conditional_block"})


def abstract_eval_op(block: ir.BlockDesc, op: ir.OpDesc,
                     lookup=None) -> InferResult:
    """Abstractly evaluate one op's emitter over its declared input
    shapes and dtypes (``shape_inference.py:119``). ``lookup(name) ->
    VarDesc | None`` resolves names across ancestor blocks."""
    # the control-flow ops are not ported (their emitters would need the
    # enclosing program), so they are skipped as the JAX package skips
    # them without one
    if op.type in _NEEDS_PROGRAM:
        return InferResult(skipped="needs-program")
    if not has_op(op.type):
        return InferResult(skipped="unregistered-op")
    spec = get_op(op.type)
    if lookup is None:
        lookup = lambda n: block.var(n) if block.has_var(n) else None  # noqa: E731

    def structs(batch_dim):
        ins = {}
        for slot, names in op.inputs.items():
            vals = []
            for n in names:
                vd = lookup(n)
                if vd is None or vd.shape is None:
                    raise _MissingShape(n)
                vals.append(_to_meta(vd, batch_dim))
            ins[slot] = vals
        return ins

    def run(ins):
        ctx = EmitContext(base_seed=0, op_index=0, op=op, device=_META)
        with _device.abstract_evaluation(), torch.no_grad():
            return spec.emit(ctx, ins, op.attrs)

    try:
        ins = structs(_SENTINEL)
    except _MissingShape:
        return InferResult(skipped="missing-input-shape")
    try:
        outs = run(ins)
    except Exception as e:  # noqa: BLE001 - every failure is classified
        if _needs_concrete(e):
            return InferResult(skipped="concrete-value-needed")
        # B and B*T map to different sentinel multiples, so shape
        # arithmetic that holds at a concrete batch can fail here; a
        # success at batch 4 marks the failure as a sentinel artefact
        had_dynamic = any(d >= _SENTINEL and d % _SENTINEL == 0
                          for vals in ins.values() for t in vals
                          for d in t.shape)
        if had_dynamic:
            try:
                run(structs(4))
                return InferResult(skipped="dynamic-dim-ambiguous")
            except Exception:  # noqa: BLE001
                pass
        logger.debug("shape inference for op %r failed: %s: %s",
                     op.type, type(e).__name__, e)
        return InferResult(error=str(e), error_type=type(e).__name__)

    result: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for n, a in zip(names, vals):
            if not isinstance(a, torch.Tensor):
                continue
            # a row-sparse gradient's shape is its dense shape
            result[n] = (_from_abstract(a.shape), _dtype_name(a.dtype))
    return InferResult(outputs=result)
