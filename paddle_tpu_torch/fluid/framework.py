"""A slim ``Program`` (the part of ``paddle_tpu/fluid/framework.py`` that
``fluid/io.py`` ``load_inference_model`` returns and the executor reads):
``desc``, ``blocks``, ``global_block()``, ``random_seed``, ``_is_test``
and ``clone(for_test=...)``, with read-only ``Block`` / ``Variable`` /
``Operator`` views over the descs. Building a program (``append_op``,
layers, shape inference) is ROADMAP A6.4's.
"""

from __future__ import annotations

from typing import Dict

from paddle_tpu_torch.core import ir


class Variable:
    """reference: framework.py:232 — a variable of a block, by its desc."""

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
    def persistable(self) -> bool:
        return self.desc.persistable

    @property
    def is_parameter(self) -> bool:
        return self.desc.is_parameter

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")


class Operator:
    """reference: framework.py:546 — an op of a block, by its desc."""

    def __init__(self, block: "Block", desc: ir.OpDesc):
        self.block = block
        self.desc = desc

    @property
    def type(self) -> str:
        return self.desc.type


class Block:
    """reference: framework.py:992 — views over one ``BlockDesc``."""

    def __init__(self, program: "Program", idx: int):
        self.program = program
        self.idx = idx
        self.desc = program.desc.block(idx)
        self.vars: Dict[str, Variable] = {
            n: Variable(self, vd) for n, vd in self.desc.vars.items()}
        self.ops = [Operator(self, od) for od in self.desc.ops]

    def var(self, name: str) -> Variable:
        return self.vars[name]

    def has_var(self, name: str) -> bool:
        return name in self.vars


class Program:
    """reference: framework.py:1510 — a program over its ``ProgramDesc``."""

    def __init__(self, desc: ir.ProgramDesc = None):
        self.desc = desc if desc is not None else ir.ProgramDesc()
        self.blocks = [Block(self, i) for i in range(len(self.desc.blocks))]
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

    def clone(self, for_test: bool = False) -> "Program":
        """reference: framework.py:1711 — a copy of the desc; ``for_test``
        runs dropout and batch norm in test mode."""
        p = Program(self.desc.clone())
        p._is_test = for_test
        return p

    def __repr__(self):
        nops = sum(len(b.desc.ops) for b in self.blocks)
        return f"Program(blocks={len(self.blocks)}, ops={nops})"
