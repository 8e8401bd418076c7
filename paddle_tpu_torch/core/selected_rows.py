"""Row-sparse gradients of the port (the lookup part of
``paddle_tpu/core/selected_rows.py``, ``:124-248``).

A row-sparse gradient of a ``[V, D]`` table is an uncoalesced
``torch.sparse_coo_tensor`` of shape ``[V, D]``: K rows, duplicates
allowed, the contract of the reference's ``RowSparseGrad`` (``:46``) and
of the port's :class:`~paddle_tpu_torch.optimizer.Adam` sparse branch.
Merging duplicates (the reference's ``deduped``) is ``coalesce()``;
densifying is ``to_dense()``, which sums duplicates exactly as the
reference's scatter-add does.

Plumbing contract (``core/lowering.py`` ``emit_op_seq``):

- the ``__vjp__`` emitter gives one for the W gradient of
  ``lookup_table`` and ``fused_embedding_seq_pool`` (``ops/grad_ops.py``);
- the sparse-apply optimizer ops (:data:`SPARSE_APPLY_OPS`) take it
  intact (``ops/optimizer_ops.py``);
- :func:`try_sparse_emit` keeps it sparse through ``sum`` over one
  table's parts (concatenation) and ``scale`` with bias 0;
- every other consumer gets an exact densify (:func:`densify_ins`).

The AMP plumbing rewrites of the reference (``elementwise_mul`` /
``elementwise_div`` by a scalar, ``isfinite``, ``cast``) and
``merge_selected_rows`` / ``get_tensor_from_selected_rows`` come with the
ops that need them (ROADMAP A6.7).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from paddle_tpu_torch import flags

# optimizer ops whose emitters apply a row-sparse gradient natively
# (ops/optimizer_ops.py sparse branches)
SPARSE_APPLY_OPS = frozenset({"sgd", "momentum", "adam"})


def row_sparse(rows: torch.Tensor, values: torch.Tensor,
               height: int) -> torch.Tensor:
    """The uncoalesced ``[height, *values.shape[1:]]`` gradient of K rows
    (``rows`` [K] integers, ``values`` [K, ...])."""
    return torch.sparse_coo_tensor(
        rows.reshape(1, -1).long(), values,
        (int(height),) + tuple(values.shape[1:]), check_invariants=False)


def is_sparse(v) -> bool:
    return isinstance(v, torch.Tensor) and v.layout == torch.sparse_coo


def sparse_grads_enabled() -> bool:
    return not flags.get("disable_sparse_grad")


def rows_values(g: torch.Tensor):
    """(rows [K], values [K, ...]) of a row-sparse gradient, duplicates
    kept."""
    return g._indices()[0], g._values()


def densify(v):
    return v.to_dense() if is_sparse(v) else v


def densify_ins(ins: Dict[str, List[Any]]) -> Dict[str, List[Any]]:
    """Densify every row-sparse input: the exact fallback for consumers
    outside the sparse-aware set."""
    return {slot: [densify(v) for v in vals] for slot, vals in ins.items()}


def try_sparse_emit(op_type: str, ins: Dict[str, List[Any]],
                    attrs: Dict[str, Any]
                    ) -> Optional[Dict[str, List[Any]]]:
    """Sparse-preserving rewrites of the linear ops between the backward
    and the optimizer apply, or None when the pattern is not sparse-safe
    (the caller then densifies and runs the op's emitter)."""
    if op_type == "sum":
        xs = ins.get("X", [])
        if xs and all(is_sparse(x) for x in xs) \
                and len({tuple(x.shape) for x in xs}) == 1:
            # all-sparse fan-in over one table: concatenation is the sum
            parts = [rows_values(x) for x in xs]
            rows = torch.cat([r for r, _ in parts])
            vals = torch.cat([v for _, v in parts])
            return {"Out": [row_sparse(rows, vals, xs[0].shape[0])]}
        return None
    if op_type == "scale":
        x = (ins.get("X") or [None])[0]
        if is_sparse(x) and float(attrs.get("bias", 0.0)) == 0.0:
            rows, vals = rows_values(x)
            return {"Out": [row_sparse(rows,
                                       vals * attrs.get("scale", 1.0),
                                       x.shape[0])]}
        return None
    return None


def record_sparse_apply(ctx, grad: torch.Tensor) -> None:
    """Remember (param -> rows a step, table height) on the enclosing
    ProgramDesc, so the executor advances
    ``paddle_sparse_rows_touched_total`` once a step for each site
    (``core/executor.py``), and set the per-table density gauge. The
    reference registers at trace time; the port at every emit, which is
    the same for a fixed feed shape. Telemetry never fails a step."""
    try:
        prog = getattr(ctx, "program", None)
        op = getattr(ctx, "op", None)
        if prog is None or op is None:
            return
        pname = (op.inputs.get("Param") or [None])[0]
        if not pname:
            return
        sites = getattr(prog, "_sparse_sites", None)
        if sites is None:
            sites = prog._sparse_sites = {}
        k, height = int(grad._nnz()), int(grad.shape[0])
        sites[pname] = (k, height)
        from paddle_tpu_torch.observability import metrics as obs_metrics
        obs_metrics.gauge(
            "paddle_sparse_table_density_ratio",
            "gradient rows carried per step / table height (duplicate "
            "ids inflate the numerator, so this is an UPPER BOUND on "
            "true touched-row density; clamped to 1)",
            ("param",)).labels(param=pname).set(min(1.0, k / max(height, 1)))
    except Exception:
        pass
