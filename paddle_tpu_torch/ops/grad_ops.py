"""The universal gradient op of the port (counterpart of
``paddle_tpu/ops/grad_ops.py``).

One ``__vjp__`` op per differentiated forward op, appended by
:func:`append_backward_desc` (``:199-326``, pure IR over
``core/ir.py``). Its emitter (``:109-196``) differentiates the forward
op's port emitter with ``torch.autograd``, with the JAX op's
``in_grad_mask`` / ``out_grad_mask`` and its rules: a float output that
no gradient reached takes a zero cotangent, and an input that does not
reach any output gets a zero gradient.

Where the JAX emitter re-traces the forward under ``jax.vjp`` and XLA
merges the re-trace with the original (``:6-8``), the port's block runner
records the forward instead: a live forward op that a live ``__vjp__``
names runs once, with grad recording on its own detached inputs
(:func:`record_forward`, ``core/lowering.py``), and the ``__vjp__`` calls
``torch.autograd.grad`` on what it kept. So each forward kernel runs once
a step, and a dropout draws its mask once. The forward is replayed inside
the ``__vjp__``, under its own RNG salt, only when it did not run (a dead
forward, such as ``mean`` when the loss is not fetched), when it carries
``__remat__``, or when the emitter is called directly.

The lookup family (:data:`SPARSE_EMB_OPS`, ``:38-83``, ``:137-149``)
takes a fast path: the W gradient is a row-sparse COO tensor
(``core/selected_rows.py``) of the gathered rows, ``padding_idx`` rows
zeroed, with no dense ``[V, D]`` scatter.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core import selected_rows as sr
from paddle_tpu_torch.core.registry import (EmitContext, get_op, has_op,
                                            register_op)

# forward op types whose W gradient is the transpose of a row gather
SPARSE_EMB_OPS = ("lookup_table", "lookup_sparse_table",
                  "fused_embedding_seq_pool")


def _slot_layout(slots: Dict[str, List[str]]) -> List[Tuple[str, int]]:
    return [(slot, len(names)) for slot, names in sorted(slots.items())]


def _flatten(d: Dict[str, List[Any]], layout, strict: bool = True
             ) -> List[Any]:
    """The values of ``d`` in slot order. ``strict=False`` (an emitter's
    outputs) gives None for a declared output the emitter did not emit."""
    out = []
    for slot, n in layout:
        vals = d.get(slot) or []
        if len(vals) < n:
            if strict:
                raise ValueError(f"slot {slot} produced {len(vals)} "
                                 f"values, expected {n}")
            vals = list(vals) + [None] * (n - len(vals))
        out.extend(vals[:n])
    return out


def _unflatten(vals: List[Any], layout) -> Dict[str, List[Any]]:
    d, i = {}, 0
    for slot, n in layout:
        d[slot] = list(vals[i:i + n])
        i += n
    return d


def _flat_pos(layout, slot) -> List[int]:
    out, pos = [], 0
    for s, n in layout:
        for _ in range(n):
            if s == slot:
                out.append(pos)
            pos += 1
    return out


def og_matches_single(og_mask, pos) -> bool:
    """True when exactly one output cotangent is given, the one at
    ``pos`` (the embedding ops' single ``Out``)."""
    return bool(og_mask[pos]) and sum(1 for m in og_mask if m) == 1


def sparse_path_applies(fwd_op: ir.OpDesc, in_grad_mask,
                        out_grad_mask) -> bool:
    """The lookup fast path's static conditions: W is the only
    differentiated input and ``Out`` the only output with a gradient."""
    if fwd_op.type not in SPARSE_EMB_OPS or not sr.sparse_grads_enabled():
        return False
    w_pos = _flat_pos(_slot_layout(fwd_op.inputs), "W")
    out_pos = _flat_pos(_slot_layout(fwd_op.outputs), "Out")
    diff_idx = [i for i, m in enumerate(in_grad_mask) if m]
    return (len(w_pos) == 1 and diff_idx == w_pos and len(out_pos) == 1
            and og_matches_single(out_grad_mask, out_pos[0]))


def _sparse_embedding_vjp(fwd_op, ins_by_slot, g) -> Optional[torch.Tensor]:
    """The row-sparse W gradient of a lookup-family op, or None when the
    shapes do not fit the pattern (the caller takes the generic path).
    ``ins_by_slot`` holds the forward inputs, ``g`` the ``Out`` gradient."""
    w = (ins_by_slot.get("W") or [None])[0]
    ids = (ins_by_slot.get("Ids") or [None])[0]
    if w is None or ids is None or g is None or w.dim() != 2:
        return None
    v, d = w.shape
    ids = ids.long()
    if fwd_op.type != "fused_embedding_seq_pool":      # lookup_table family
        rows = ids.reshape(-1)
        if g.numel() != rows.shape[0] * d:
            return None
        vals = g.reshape(rows.shape[0], d)
        padding_idx = fwd_op.attrs.get("padding_idx", -1)
        if padding_idx is not None and padding_idx >= 0:
            # the forward zeroes padding rows, so their cotangent is dead
            vals = torch.where((rows == padding_idx)[:, None],
                               torch.zeros((), dtype=vals.dtype,
                                           device=vals.device), vals)
    else:           # fused_embedding_seq_pool: Out [B, D] fans out over T
        if ids.dim() == 3:
            ids = ids[..., 0]
        if ids.dim() != 2 or tuple(g.shape) != (ids.shape[0], d):
            return None
        b, t = ids.shape
        vals = g[:, None, :].expand(b, t, d)
        lens = (ins_by_slot.get("SeqLens") or [None])[0]
        if lens is not None:
            from paddle_tpu_torch.ops.sequence_ops import _mask_bt
            mask = _mask_bt(lens, b, t, g.device)
            vals = vals * mask[:, :, None].to(vals.dtype)
        rows = ids.reshape(-1)
        vals = vals.reshape(b * t, d)
    return sr.row_sparse(rows, vals.to(w.dtype).contiguous(), v)


def record_forward(ctx: EmitContext, fwd_op: ir.OpDesc, ins, in_grad_mask
                   ) -> Tuple[Dict[str, List[Any]], Tuple[list, list]]:
    """Run ``fwd_op``'s emitter with grad recording on detached copies of
    its differentiated inputs: ``(outs, (leaves, flat_outs))``. ``outs``
    is the emitter's dict with every tensor detached (what the block's
    environment keeps); the pair is what its ``__vjp__`` differentiates.
    ``flat_outs`` holds only the outputs that carry grad, None in the
    place of the others (a dropout's Mask), so the tape keeps no tensor
    that its ``__vjp__`` skips."""
    in_layout = _slot_layout(fwd_op.inputs)
    vals = _flatten(ins, in_layout)
    leaves = []
    for i, m in enumerate(in_grad_mask):
        if m:
            leaf = vals[i].detach()
            if leaf.is_floating_point():
                leaf.requires_grad_(True)
            vals[i] = leaf
            leaves.append(leaf)
    with torch.enable_grad():
        outs = get_op(fwd_op.type).emit(ctx, _unflatten(vals, in_layout),
                                        fwd_op.attrs)
    flat_outs = [o if isinstance(o, torch.Tensor) and o.requires_grad
                 else None
                 for o in _flatten(outs, _slot_layout(fwd_op.outputs),
                                   strict=False)]
    detached = {slot: [v.detach() if isinstance(v, torch.Tensor) else v
                       for v in vs] for slot, vs in outs.items()}
    return detached, (leaves, flat_outs)


@register_op("__vjp__", no_grad=True,
             ref="framework/grad_op_desc_maker.h (capability)")
def _vjp_emit(ctx: EmitContext, ins, attrs):
    fwd_op = ir.OpDesc.from_dict(attrs["fwd_op"])
    in_layout = _slot_layout(fwd_op.inputs)
    flat_in = ins.get("FwdIn", [])
    diff_mask = attrs["in_grad_mask"]
    og_mask = attrs["out_grad_mask"]
    ograds = ins.get("OutGrad", [])

    if sparse_path_applies(fwd_op, diff_mask, og_mask):
        wgrad = _sparse_embedding_vjp(fwd_op, _unflatten(flat_in, in_layout),
                                      ograds[0])
        if wgrad is not None:
            return {"InGrad": [wgrad]}

    fwd_index = attrs["fwd_op_index"]
    # the runner kept the forward unless it was dead or __remat__
    rec = ctx.tape.pop(fwd_index, None) if ctx.tape is not None else None
    if rec is None:
        # replay under the forward op's own salt (the one emit_op_seq
        # gave it), so its random draws are the forward's
        block_base = (ctx.op_index // 100_000) * 100_000
        fwd_ctx = EmitContext(
            base_seed=ctx.base_seed, step_base_seed=ctx.step_base_seed,
            op_index=block_base + fwd_op.attrs.get("__op_index__",
                                                   fwd_index),
            is_test=ctx.is_test, program=ctx.program, op=fwd_op,
            device=ctx.device)
        _, rec = record_forward(fwd_ctx, fwd_op,
                                _unflatten(flat_in, in_layout), diff_mask)
    leaves, flat_outs = rec

    og_by_flat: Dict[int, Any] = {}
    j = 0
    for k, present in enumerate(og_mask):
        if present:
            og_by_flat[k] = ograds[j]
            j += 1
    outputs, cotangents = [], []
    for k, o in enumerate(flat_outs):
        if not (isinstance(o, torch.Tensor) and o.requires_grad):
            continue            # not float, or reached by no input
        g = og_by_flat.get(k)
        outputs.append(o)
        cotangents.append(torch.zeros_like(o) if g is None
                          else g.reshape(o.shape).to(o.dtype))
    wants = [leaf for leaf in leaves if leaf.requires_grad]
    grads = (torch.autograd.grad(outputs, wants, cotangents,
                                 allow_unused=True)
             if outputs and wants else [None] * len(wants))
    by_leaf = dict(zip(map(id, wants), grads))
    gin = []
    for leaf in leaves:
        g = by_leaf.get(id(leaf))
        gin.append(torch.zeros_like(leaf) if g is None else g)
    return {"InGrad": gin}


GRAD_SUFFIX = "@GRAD"


def append_backward_desc(block: ir.BlockDesc, loss_name: str,
                         no_grad_set=None) -> Dict[str, str]:
    """Reverse-mode autodiff over the block's op list (the reference's
    ``append_backward``, python/paddle/fluid/backward.py:394): walks the
    ops in reverse, appends one ``__vjp__`` op per relevant forward op,
    inserts ``sum`` ops where a variable's gradient fans in from several
    consumers, and returns {var_name: grad_var_name}. An op type the port
    has not registered counts as differentiable, as it is in the
    reference's registry."""
    no_grad_set = set(no_grad_set or ())

    def var_stops(n: str) -> bool:
        if n in no_grad_set:
            return True
        if block.has_var(n):
            v = block.var(n)
            if v.stop_gradient:
                return True
            if not v.dtype.startswith(("float", "bfloat")):
                return True
        return False

    def no_grad(op_type: str) -> bool:
        return has_op(op_type) and get_op(op_type).no_grad

    # relevance: ops backward-reachable from the loss
    n_fwd = len(block.ops)
    needed = {loss_name}
    relevant = [False] * n_fwd
    for i in range(n_fwd - 1, -1, -1):
        op = block.ops[i]
        if op.type in ("feed", "fetch") or no_grad(op.type):
            continue
        if set(op.output_names()) & needed:
            relevant[i] = True
            needed.update(op.input_names())

    # loss@GRAD = ones
    loss_var = block.var(loss_name)
    loss_grad = loss_name + GRAD_SUFFIX
    block.append_op(ir.OpDesc(
        type="fill_constant",
        outputs={"Out": [loss_grad]},
        attrs={"shape": list(loss_var.shape or []), "value": 1.0,
               "dtype": loss_var.dtype},
    ))
    _add_grad_var(block, loss_grad, loss_var)

    # pending[v] = the partial-gradient names awaiting aggregation
    pending: Dict[str, List[str]] = {loss_name: [loss_grad]}
    finalized: Dict[str, str] = {}

    def finalize(v: str) -> str:
        if v in finalized:
            return finalized[v]
        parts = pending.get(v, [])
        if not parts:
            return ""
        gname = v + GRAD_SUFFIX
        if len(parts) == 1:
            gname = parts[0]
        else:
            block.append_op(ir.OpDesc(type="sum", inputs={"X": list(parts)},
                                      outputs={"Out": [gname]}))
            _add_grad_var(block, gname,
                          block.var(v) if block.has_var(v) else None)
        finalized[v] = gname
        return gname

    for i in range(n_fwd - 1, -1, -1):
        if not relevant[i]:
            continue
        op = block.ops[i]
        flat_in = _flatten({s: list(ns) for s, ns in op.inputs.items()},
                           _slot_layout(op.inputs))
        flat_out = _flatten({s: list(ns) for s, ns in op.outputs.items()},
                            _slot_layout(op.outputs))

        og_names, og_mask = [], []
        for o in flat_out:
            g = finalize(o)
            og_mask.append(bool(g))
            if g:
                og_names.append(g)
        if not any(og_mask):
            continue

        in_grad_mask = [not var_stops(n) for n in flat_in]
        if not any(in_grad_mask):
            continue

        grad_out_names = []
        for n, m in zip(flat_in, in_grad_mask):
            if not m:
                continue
            parts = pending.setdefault(n, [])
            gname = (n + GRAD_SUFFIX if not parts
                     else f"{n}{GRAD_SUFFIX}@RENAME@{len(parts)}")
            parts.append(gname)
            grad_out_names.append(gname)
            _add_grad_var(block, gname,
                          block.var(n) if block.has_var(n) else None)

        block.append_op(ir.OpDesc(
            type="__vjp__",
            inputs={"FwdIn": list(flat_in), "OutGrad": og_names},
            outputs={"InGrad": grad_out_names},
            attrs={
                "fwd_op": op.to_dict(),
                "fwd_op_index": i,
                "in_grad_mask": in_grad_mask,
                "out_grad_mask": og_mask,
            },
        ))

    # finalize the remaining gradients (parameters are usually leaves)
    grad_map: Dict[str, str] = {}
    for v in list(pending):
        g = finalize(v)
        if g:
            grad_map[v] = g
    return grad_map


def _add_grad_var(block: ir.BlockDesc, gname: str,
                  base: "ir.VarDesc | None"):
    if block.has_var(gname):
        return
    block.add_var(ir.VarDesc(
        name=gname,
        shape=list(base.shape) if base is not None and base.shape else None,
        dtype=base.dtype if base is not None else "float32",
        stop_gradient=True,
    ))
