"""Program IR of the port (its own copy of ``paddle_tpu/core/ir.py``, which
imports no JAX): ``ProgramDesc`` > ``BlockDesc`` > ``OpDesc`` / ``VarDesc``
as plain-Python dataclasses with the reference's JSON form.

The JSON is the contract between the two packages: a program serialized by
either side (``serialize_to_string``, ``to_dict``; the ``program`` of a
saved model's ``__model__.json``) parses on the other, and a round trip
gives the same bytes. The port interprets a block op by op
(``core/lowering.py``) instead of tracing it into one compiled function;
the IR does not change for that.
"""

from __future__ import annotations

import copy
import enum
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class VarType(enum.IntEnum):
    """Variable kinds (reference: framework.proto:105-162 VarType enumerates
    LOD_TENSOR, SELECTED_ROWS, LOD_TENSOR_ARRAY, READER, ... ).

    DENSE_TENSOR is the workhorse; LOD_TENSOR's variable-length sequence
    capability is delivered through padded batches and lengths
    (``ops/sequence_ops.py``), so LOD_TENSOR is an alias carrying an
    optional lod_level. SELECTED_ROWS (sparse gradients) appear as
    (ids, rows) pairs feeding scatter-adds.
    """

    DENSE_TENSOR = 0
    LOD_TENSOR = 1
    SELECTED_ROWS = 2
    TENSOR_ARRAY = 3
    READER = 4
    STEP_SCOPES = 5
    FETCH_LIST = 6
    FEED_MINIBATCH = 7
    RAW = 8


# Canonical dtype strings (numpy-style). The reference keys kernels on a
# proto DataType (framework.proto:105); these strings map 1:1 onto numpy
# and torch dtypes, bfloat16 included.
_VALID_DTYPES = {
    "float32",
    "float64",
    "float16",
    "bfloat16",
    "int8",
    "uint8",
    "int16",
    "int32",
    "int64",
    "bool",
}


@dataclass
class VarDesc:
    """Variable description (reference: framework.proto:165, var_desc.cc).

    shape uses -1 for the dynamic batch dimension; concrete shapes are bound
    at compile time from the feed signature (the reference re-runs InferShape
    every step — operator.cc:963; we infer once per compiled signature).
    """

    name: str
    type: VarType = VarType.LOD_TENSOR
    shape: Optional[List[int]] = None
    dtype: str = "float32"
    lod_level: int = 0
    persistable: bool = False
    stop_gradient: bool = False
    is_parameter: bool = False
    # free-form attributes (initializer info, regularizer, trainable, ...)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.dtype not in _VALID_DTYPES:
            raise ValueError(f"invalid dtype {self.dtype!r} for var {self.name!r}")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "type": int(self.type),
            "shape": self.shape,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_parameter": self.is_parameter,
            "attrs": _jsonable_attrs(self.attrs),
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "VarDesc":
        return VarDesc(
            name=d["name"],
            type=VarType(d.get("type", 1)),
            shape=d.get("shape"),
            dtype=d.get("dtype", "float32"),
            lod_level=d.get("lod_level", 0),
            persistable=d.get("persistable", False),
            stop_gradient=d.get("stop_gradient", False),
            is_parameter=d.get("is_parameter", False),
            attrs=d.get("attrs", {}) or {},
        )


@dataclass
class OpDesc:
    """Operator description (reference: framework.proto:43, op_desc.cc).

    inputs/outputs map *slot names* (e.g. "X", "Out") to lists of variable
    names — the same multi-slot convention the reference uses, which the
    grad machinery relies on.
    """

    type: str
    inputs: Dict[str, List[str]] = field(default_factory=dict)
    outputs: Dict[str, List[str]] = field(default_factory=dict)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def input_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": _jsonable_attrs(self.attrs),
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "OpDesc":
        return OpDesc(
            type=d["type"],
            inputs={k: list(v) for k, v in d.get("inputs", {}).items()},
            outputs={k: list(v) for k, v in d.get("outputs", {}).items()},
            attrs=d.get("attrs", {}) or {},
        )


@dataclass
class BlockDesc:
    """A straight-line list of ops plus its variable symbol table
    (reference: framework.proto:171, block_desc.cc). Sub-blocks implement
    control flow (while/cond bodies; reference:
    operators/controlflow/while_op.cc:50). The port's block runner refuses
    them for now (``core/lowering.py`` ``check_supported``).
    """

    idx: int = 0
    parent_idx: int = -1
    vars: Dict[str, VarDesc] = field(default_factory=dict)
    ops: List[OpDesc] = field(default_factory=list)

    def var(self, name: str) -> VarDesc:
        return self.vars[name]

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def add_var(self, desc: VarDesc) -> VarDesc:
        self.vars[desc.name] = desc
        return desc

    def append_op(self, op: OpDesc) -> OpDesc:
        self.ops.append(op)
        return op

    def prepend_op(self, op: OpDesc) -> OpDesc:
        self.ops.insert(0, op)
        return op

    def to_dict(self) -> Dict[str, Any]:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": {k: v.to_dict() for k, v in self.vars.items()},
            "ops": [op.to_dict() for op in self.ops],
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "BlockDesc":
        return BlockDesc(
            idx=d.get("idx", 0),
            parent_idx=d.get("parent_idx", -1),
            vars={k: VarDesc.from_dict(v) for k, v in d.get("vars", {}).items()},
            ops=[OpDesc.from_dict(o) for o in d.get("ops", [])],
        )


class ProgramDesc:
    """The whole serialized program (reference: framework.proto:184,
    program_desc.cc). Version counter invalidates compiled-executable caches
    when the program mutates (the reference instead re-Prepares per run —
    executor.cc:372)."""

    IR_VERSION = 1

    def __init__(self):
        self.blocks: List[BlockDesc] = [BlockDesc(idx=0)]
        self.random_seed: int = 0
        self._mutation_counter = 0

    # -- block management -------------------------------------------------
    def block(self, idx: int) -> BlockDesc:
        return self.blocks[idx]

    @property
    def global_block(self) -> BlockDesc:
        return self.blocks[0]

    def append_block(self, parent_idx: int) -> BlockDesc:
        b = BlockDesc(idx=len(self.blocks), parent_idx=parent_idx)
        self.blocks.append(b)
        return b

    def bump_version(self):
        self._mutation_counter += 1

    @property
    def version_token(self):
        return (id(self), self._mutation_counter)

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "ir_version": self.IR_VERSION,
            "random_seed": self.random_seed,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    def serialize_to_string(self) -> bytes:
        return json.dumps(self.to_dict(), sort_keys=True).encode("utf-8")

    @staticmethod
    def parse_from_string(data: bytes) -> "ProgramDesc":
        d = json.loads(data.decode("utf-8"))
        p = ProgramDesc()
        p.random_seed = d.get("random_seed", 0)
        p.blocks = [BlockDesc.from_dict(b) for b in d.get("blocks", [])]
        if not p.blocks:
            p.blocks = [BlockDesc(idx=0)]
        return p

    def clone(self) -> "ProgramDesc":
        p = ProgramDesc()
        p.random_seed = self.random_seed
        p.blocks = copy.deepcopy(self.blocks)
        return p


def _jsonable_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool, type(None))):
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = list(v)
        elif isinstance(v, dict):
            out[k] = _jsonable_attrs(v)
        else:
            out[k] = repr(v)
    return out


def find_var_recursive(program: "ProgramDesc", block: "BlockDesc",
                       name: str) -> Optional[VarDesc]:
    """Resolve `name` in `block` or its ancestor chain (reference:
    framework.py Block._var_recursive — sub-block ops may reference
    parent-scope vars, e.g. parameters in block 0). Returns None if absent
    everywhere."""
    b = block
    while True:
        if b.has_var(name):
            return b.var(name)
        if b.idx == 0 or b.parent_idx < 0 or b.parent_idx == b.idx:
            return None
        b = program.block(b.parent_idx)


# ---------------------------------------------------------------------------
# Pruning (reference: framework/prune.cc; used by save_inference_model,
# io.py:570): keep only ops needed to compute `targets` from feeds.
# ---------------------------------------------------------------------------

def prune_block(block: BlockDesc, target_names: List[str], feed_names: List[str]) -> BlockDesc:
    needed = set(target_names)
    kept_rev: List[OpDesc] = []
    feed_set = set(feed_names)
    for op in reversed(block.ops):
        if op.type in ("feed", "fetch"):
            continue
        produces = set(op.output_names())
        if produces & needed:
            kept_rev.append(op)
            for n in op.input_names():
                if n not in feed_set:
                    needed.add(n)
    kept = list(reversed(kept_rev))
    new_block = BlockDesc(idx=block.idx, parent_idx=block.parent_idx)
    referenced = set(feed_names) | set(target_names)
    for op in kept:
        referenced.update(op.input_names())
        referenced.update(op.output_names())
    for name in referenced:
        if block.has_var(name):
            new_block.add_var(copy.deepcopy(block.var(name)))
    new_block.ops = kept
    return new_block
