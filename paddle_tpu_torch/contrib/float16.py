"""Reduced-precision inference transpilers (counterpart of
``paddle_tpu/contrib/float16.py``; reference:
contrib/float16/float16_transpiler.py): a test-mode program rewritten to
run in bf16 (:class:`BF16Transpiler`) or fp16 (:class:`Float16Transpiler`).

``transpile(program, place, scope, feed_names, fetch_names)``, as the JAX
one:

1. every persistable fp32 variable of the global block that the scope
   holds is cast there, in place, to the reduced dtype (on its own
   device), and its var desc says so;
2. a ``cast`` to the reduced dtype is put after each fp32 feed (the ops
   read ``<feed>@BF16``), and each produced float fetch is written as
   ``<fetch>@PREF32`` and cast back to fp32 under its own name by a last
   ``cast`` op.

The port's executor and predictor then run the interior in the reduced
dtype: its ops follow their inputs' dtype (a bf16 ``mul`` gives bf16,
a bf16 batch norm takes its low-precision path), with fp32 islands where
an op computes in fp32 (the losses, the statistics of the norms).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.registry import TORCH_DTYPES


class BF16Transpiler:
    """reference: float16_transpiler.py Float16Transpiler.transpile
    (program, place, scope)."""

    target_dtype = "bfloat16"

    def transpile(self, program, place=None, scope=None,
                  feed_names=None, fetch_names=None):
        """Rewrite ``program`` (and cast ``scope``, default the global
        scope) as the module docstring says; returns ``program``.
        ``place`` is taken for the reference's signature: the cast values
        stay on their own device."""
        from paddle_tpu_torch.core.scope import global_scope
        scope = scope or global_scope()
        block = program.desc.global_block
        dtype = TORCH_DTYPES[self.target_dtype]

        for name, vd in block.vars.items():
            if not vd.persistable or vd.dtype != "float32":
                continue
            val = scope.find_var(name)
            if val is None:
                continue
            scope.set_var(name, torch.as_tensor(val).to(dtype))
            vd.dtype = self.target_dtype

        renames, new_ops = {}, []
        for fname in feed_names or []:
            if not block.has_var(fname):
                continue
            vd = block.var(fname)
            if vd.dtype != "float32":
                continue                       # int feeds stay integral
            half = fname + "@BF16"
            block.add_var(ir.VarDesc(name=half, shape=vd.shape,
                                     dtype=self.target_dtype))
            new_ops.append(ir.OpDesc(
                type="cast", inputs={"X": [fname]}, outputs={"Out": [half]},
                attrs={"in_dtype": "float32",
                       "out_dtype": self.target_dtype}))
            renames[fname] = half
        for op in block.ops:
            op.inputs = {slot: [renames.get(n, n) for n in names]
                         for slot, names in op.inputs.items()}
        block.ops[:0] = new_ops

        for fname in fetch_names or []:
            if not block.has_var(fname):
                continue
            vd = block.var(fname)
            if vd.dtype not in ("float32", self.target_dtype):
                continue                       # int fetches stay integral
            if not any(fname in names for op in block.ops
                       for names in op.outputs.values()):
                continue       # a feed or parameter fetched: nothing to do
            half = fname + "@PREF32"
            # the producer writes the @PREF32 temp and every consumer reads
            # it; the last cast writes the fp32 fetch under its own name
            for op in block.ops:
                op.outputs = {slot: [half if n == fname else n
                                     for n in names]
                              for slot, names in op.outputs.items()}
                op.inputs = {slot: [half if n == fname else n
                                    for n in names]
                             for slot, names in op.inputs.items()}
            block.add_var(ir.VarDesc(name=half, shape=vd.shape,
                                     dtype=self.target_dtype))
            vd.dtype = "float32"
            block.append_op(ir.OpDesc(
                type="cast", inputs={"X": [half]}, outputs={"Out": [fname]},
                attrs={"in_dtype": self.target_dtype,
                       "out_dtype": "float32"}))

        program.desc.bump_version()
        return program


class Float16Transpiler(BF16Transpiler):
    """The reference's spelling: fp16 proper (bf16 keeps fp32's exponent
    range and is the card's choice too)."""

    target_dtype = "float16"
