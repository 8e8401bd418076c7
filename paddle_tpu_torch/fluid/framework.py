"""The program builder of the port: ``Program`` / ``Block`` / ``Variable``
/ ``Parameter`` / ``Operator`` (counterpart of
``paddle_tpu/fluid/framework.py``; reference:
python/paddle/fluid/framework.py — Variable :232, Operator :546, Block
:992, Program :1510, Program.clone :1711, program_guard).

The wrappers mutate the ``core/ir.py`` descs directly. ``Block.append_op``
infers the new op's output shapes and dtypes once, by running the op's
port emitter over meta tensors (``core/shape_inference.py``), where the
JAX package evaluates its JAX emitter under ``jax.eval_shape``. So a
program built here equals, op for op and var for var, the JAX package's
build of the same layers under the same ``unique_name`` guard.

A loaded desc is wrapped the same way: ``Program(desc)`` gives views over
its blocks, variables (parameters where the desc says so) and ops, which
is what ``fluid.io.load_inference_model`` returns.
"""

from __future__ import annotations

import contextlib
import json
from typing import Any, Dict, List, Optional

import numpy as np

from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.shape_inference import abstract_eval_op
from paddle_tpu_torch.fluid import unique_name


class Variable:
    """reference: framework.py:232 — a symbolic tensor in a block."""

    def __init__(self, block: "Block", desc: ir.VarDesc):
        self.block = block
        self.desc = desc

    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def shape(self):
        return tuple(self.desc.shape) if self.desc.shape is not None else None

    @property
    def dtype(self) -> str:
        return self.desc.dtype

    @property
    def lod_level(self) -> int:
        return self.desc.lod_level

    @property
    def persistable(self) -> bool:
        return self.desc.persistable

    @persistable.setter
    def persistable(self, v: bool):
        self.desc.persistable = v

    @property
    def stop_gradient(self) -> bool:
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v: bool):
        self.desc.stop_gradient = v

    @property
    def is_parameter(self) -> bool:
        return self.desc.is_parameter

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")

    # numpy-style sugar on symbolic vars appends the elementwise ops
    def __add__(self, other):
        from paddle_tpu_torch.fluid.layers import elementwise_add
        return elementwise_add(self, _to_variable(other, self))

    def __sub__(self, other):
        from paddle_tpu_torch.fluid.layers import elementwise_sub
        return elementwise_sub(self, _to_variable(other, self))

    def __mul__(self, other):
        from paddle_tpu_torch.fluid.layers import elementwise_mul
        return elementwise_mul(self, _to_variable(other, self))

    def __truediv__(self, other):
        from paddle_tpu_torch.fluid.layers import elementwise_div
        return elementwise_div(self, _to_variable(other, self))


def _to_variable(x, like: Variable) -> Variable:
    if isinstance(x, Variable):
        return x
    from paddle_tpu_torch.fluid.layers import fill_constant
    return fill_constant(shape=[1], dtype=like.dtype, value=float(x))


class Parameter(Variable):
    """reference: framework.py Parameter — a persistable trainable var with
    its optimizer, regularizer and clip attributes."""

    def __init__(self, block, desc, trainable=True, optimize_attr=None,
                 regularizer=None, gradient_clip_attr=None,
                 do_model_average=False):
        super().__init__(block, desc)
        self.trainable = trainable
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}
        self.regularizer = regularizer
        self.gradient_clip_attr = gradient_clip_attr
        self.do_model_average = do_model_average
        desc.is_parameter = True
        desc.persistable = True
        desc.stop_gradient = False

    @classmethod
    def view(cls, block, desc, like: Optional["Parameter"] = None):
        """A parameter over an existing desc, left as it is (a loaded or
        cloned program); ``like`` gives the attributes."""
        p = cls.__new__(cls)
        Variable.__init__(p, block, desc)
        p.trainable = like.trainable if like else True
        p.optimize_attr = dict(like.optimize_attr) if like \
            else {"learning_rate": 1.0}
        p.regularizer = like.regularizer if like else None
        p.gradient_clip_attr = like.gradient_clip_attr if like else None
        p.do_model_average = like.do_model_average if like else False
        return p


class Operator:
    """reference: framework.py:546 — a thin wrapper over an ``OpDesc``."""

    def __init__(self, block: "Block", desc: ir.OpDesc):
        self.block = block
        self.desc = desc

    @property
    def type(self) -> str:
        return self.desc.type

    def input(self, slot):
        return self.desc.input(slot)

    def output(self, slot):
        return self.desc.output(slot)

    @property
    def attrs(self):
        return self.desc.attrs


class Block:
    """reference: framework.py:992."""

    def __init__(self, program: "Program", idx: int):
        self.program = program
        self.idx = idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def desc(self) -> ir.BlockDesc:
        return self.program.desc.block(self.idx)

    def _wrap_desc(self, like: Optional["Block"] = None):
        """Views over what the desc already holds: its variables (a
        parameter where ``like`` has one or the desc says so) and ops."""
        for name, vd in self.desc.vars.items():
            src = like.vars.get(name) if like is not None else None
            if isinstance(src, Parameter) or (src is None and vd.is_parameter):
                self.vars[name] = Parameter.view(self, vd, src)
            else:
                self.vars[name] = Variable(self, vd)
        self.ops = [Operator(self, od) for od in self.desc.ops]

    # -- var management ----------------------------------------------------
    def create_var(self, name: Optional[str] = None, shape=None,
                   dtype="float32", lod_level: int = 0,
                   persistable: bool = False, stop_gradient: bool = False,
                   type: ir.VarType = ir.VarType.LOD_TENSOR) -> Variable:
        if name is None:
            name = unique_name.generate("_generated_var")
        desc = ir.VarDesc(name=name, type=type,
                          shape=list(shape) if shape is not None else None,
                          dtype=dtype, lod_level=lod_level,
                          persistable=persistable, stop_gradient=stop_gradient)
        self.desc.add_var(desc)
        v = Variable(self, desc)
        self.vars[name] = v
        self.program.desc.bump_version()
        return v

    def create_parameter(self, name: str, shape, dtype="float32",
                         **kwargs) -> Parameter:
        desc = ir.VarDesc(name=name, shape=list(shape), dtype=dtype,
                          persistable=True)
        self.desc.add_var(desc)
        p = Parameter(self, desc, **kwargs)
        self.vars[name] = p
        self.program.desc.bump_version()
        return p

    def var(self, name: str) -> Variable:
        v = self.vars.get(name)
        if v is None:
            if not self.desc.has_var(name):
                raise KeyError(
                    f"variable {name!r} not found in block {self.idx}")
            v = Variable(self, self.desc.var(name))
            self.vars[name] = v
        return v

    def has_var(self, name: str) -> bool:
        return name in self.vars or self.desc.has_var(name)

    def var_recursive(self, name: str) -> Variable:
        """``name`` here or in an ancestor block (reference: framework.py
        Block._var_recursive)."""
        b = self
        while True:
            if b.has_var(name):
                return b.var(name)
            pidx = b.desc.parent_idx
            if pidx < 0 or b.idx == pidx:
                raise KeyError(f"variable {name!r} not found in block "
                               f"{self.idx} or its ancestors")
            b = self.program.blocks[pidx]

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- op management -----------------------------------------------------
    def append_op(self, type: str, inputs: Optional[Dict[str, Any]] = None,
                  outputs: Optional[Dict[str, Any]] = None,
                  attrs: Optional[Dict[str, Any]] = None) -> Operator:
        op_desc = ir.OpDesc(type=type, inputs=_names_of(inputs),
                            outputs=_names_of(outputs),
                            attrs=dict(attrs or {}))
        self.desc.append_op(op_desc)
        op = Operator(self, op_desc)
        self.ops.append(op)
        self.program.desc.bump_version()
        self._infer_shapes(op_desc)
        return op

    def _infer_shapes(self, op_desc: ir.OpDesc):
        """Write the inferred shapes and dtypes over the declared ones of
        the op's outputs; a skip or an emitter error leaves them as they
        are (``framework.py:218-232``)."""
        def lookup(name):
            return ir.find_var_recursive(self.program.desc, self.desc, name)

        res = abstract_eval_op(self.desc, op_desc, lookup=lookup)
        if not res.ok:
            return
        for name, (shape, dtype) in res.outputs.items():
            if self.desc.has_var(name):
                vd = self.desc.var(name)
                if vd.shape is None or tuple(vd.shape) != shape:
                    vd.shape = list(shape)
                vd.dtype = dtype


def _names_of(slot_map) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for slot, vals in (slot_map or {}).items():
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        names = [v.name if isinstance(v, Variable) else str(v) for v in vals]
        if names:
            out[slot] = names
    return out


class Program:
    """reference: framework.py:1510. ``Program()`` starts an empty
    program; ``Program(desc)`` wraps a loaded ``ProgramDesc``."""

    def __init__(self, desc: Optional[ir.ProgramDesc] = None):
        self.desc = desc if desc is not None else ir.ProgramDesc()
        self.blocks = [Block(self, i) for i in range(len(self.desc.blocks))]
        if desc is not None:
            for b in self.blocks:
                b._wrap_desc()
        self._current_block_idx = 0
        self._is_test = False

    @property
    def random_seed(self) -> int:
        return self.desc.random_seed

    @random_seed.setter
    def random_seed(self, s: int):
        self.desc.random_seed = int(s)
        self.desc.bump_version()

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def create_block(self) -> Block:
        self.desc.append_block(self._current_block_idx)
        b = Block(self, len(self.blocks))
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def rollback(self):
        parent = self.desc.block(self._current_block_idx).parent_idx
        self._current_block_idx = max(parent, 0)

    def clone(self, for_test: bool = False) -> "Program":
        """reference: framework.py:1711 — a copy of the desc with views
        over it; ``for_test`` runs dropout and batch norm in test mode."""
        p = Program.__new__(Program)
        p.desc = self.desc.clone()
        p.blocks = [Block(p, i) for i in range(len(p.desc.blocks))]
        for b in p.blocks:
            b._wrap_desc(self.blocks[b.idx] if b.idx < len(self.blocks)
                         else None)
        p._current_block_idx = 0
        p._is_test = for_test
        return p

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self):
        return self.global_block().all_parameters()

    def to_string(self, throw_on_error=False) -> str:
        return json.dumps(self.desc.to_dict(), indent=1)

    def __repr__(self):
        nops = sum(len(b.desc.ops) for b in self.blocks)
        return f"Program(blocks={len(self.blocks)}, ops={nops})"


# ---------------------------------------------------------------------------
# the two-program convention and its guards (reference: framework.py
# default_main_program / default_startup_program, program_guard)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


def reset_default_programs():
    """Fresh default programs (a test's hook)."""
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()


def convert_dtype(dtype) -> str:
    """A dtype as the IR's string (fluid's ``convert_np_dtype_to_dtype_``)."""
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


@contextlib.contextmanager
def name_scope(prefix=None):
    """reference: framework.py:107 — a name prefix for what is created
    inside. The per-key counters stay shared with the enclosing generator,
    so two scopes of one prefix still give unique names."""
    token = f"{prefix or ''}/"
    old = unique_name._generator
    scoped = unique_name.NameGenerator(getattr(old, "prefix", "") + token)
    scoped.ids = old.ids
    unique_name._generator = scoped
    try:
        yield
    finally:
        unique_name._generator = old
