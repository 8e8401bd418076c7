"""The NHWC layout rewrite (counterpart of ``paddle_tpu/contrib/layout.py``):
:func:`rewrite_program_nhwc` tags the maximal channels-last regions of a
program's block 0, attrs only, as the JAX rewrite tags them.

Each convertible op (``CONVERT_SLOTS``: ``conv2d``, ``depthwise_conv2d``,
``conv2d_fusion``, ``pool2d``, ``batch_norm``) gets ``__nhwc__`` with its
region-edge flags ``__nhwc_in_ready__`` / ``__nhwc_out_keep__`` (and
``conv2d_fusion`` ``__nhwc_resid_ready__``); an elementwise binary over a
resident X gets ``__nhwc_bcast__`` ([C] at axis 1) or ``__nhwc_bcast_bc__``
([B, C] at axis 0); a channel ``concat`` gets ``__nhwc_concat__``; every
resident var desc gets ``__nhwc__``, its gradient the forward var's
residency; the ``__vjp__`` snapshots get their forward op's tags, matched
by :func:`fluid.ir_pass.vjp_snapshot_key` so that a pass pipeline that
renumbered the ops before the rewrite does not misplace them. The
residency is the JAX fixpoint (``:115-198``): every produced rank-4
activation starts resident, and the constraints of each op falsify until
nothing changes, the gradient-var conflict loop included.

What the tags mean in the port. The JAX emitters transpose to a physical
NHWC array at a region's edges and re-aim the broadcasts and the concat
at its last axis. The port keeps every tensor's logical NCHW shape and
gives a resident one channels-last strides (``torch.channels_last``):
the tagged emitters convert at the region's edges (``ops/nn_ops.py``
``nhwc_in`` / ``nhwc_out``), cuDNN takes channels-last maps directly,
every untagged op and shape inference see the shapes they expect, and
the broadcast and concat tags are identities. Apply it after (or
before) ``minimize``, as ``rewrite_program_amp``:

    rewrite_program_nhwc(main_program)
"""

from __future__ import annotations

from paddle_tpu_torch.contrib.mixed_precision import ELEMENTWISE_OPS

# data slots of convertible ops: (input slot, output slot)
CONVERT_SLOTS = {
    "conv2d": ("Input", "Output"),
    "depthwise_conv2d": ("Input", "Output"),
    "conv2d_fusion": ("Input", "Output"),
    "pool2d": ("X", "Out"),
    "batch_norm": ("X", "Y"),
}

# layout-transparent ops: rank-4 inputs/outputs all share one layout
AGNOSTIC = {
    "relu", "leaky_relu", "relu6", "sigmoid", "tanh", "sqrt", "square",
    "abs", "exp", "scale", "cast", "dropout", "clip", "swish",
    "hard_sigmoid", "elu", "pow", "soft_relu", "brelu", "sum",
}

ELEMENTWISE = ELEMENTWISE_OPS


def _op_bcast_kind(op, var_lookup):
    """:func:`_bcast_kind` of an elementwise op (its Y's shape and its
    ``axis``), the one reading shared by the fixpoint and the tagging."""
    y = (op.inputs.get("Y") or [None])[0]
    yv = var_lookup(y)
    ys = yv.shape if (yv is not None and yv.shape is not None) else None
    return _bcast_kind(ys, op.attrs.get("axis", -1))


def _bcast_kind(ys, axis):
    """An elementwise op's Y broadcast against a rank-4 X: 'scalar'
    (rank 0 or [1]), 'chan' ([C] at axis 1), 'bc' ([B, C] at axis 0, the
    squeeze-excitation gate), 'full' (rank 4), or None (a positional
    broadcast that keeps X out of a region)."""
    if ys is None:
        return None
    if len(ys) == 0 or (len(ys) == 1 and ys[0] == 1):
        return "scalar"
    if len(ys) == 1 and axis == 1:
        return "chan"
    if len(ys) == 2 and axis == 0:
        return "bc"
    if len(ys) >= 4:
        return "full"
    return None


def rewrite_program_nhwc(program=None) -> int:
    """Tag the NHWC regions of block 0 of ``program`` (None: the default
    main program); returns the number of ops tagged."""
    if program is None:
        from paddle_tpu_torch.fluid import framework
        program = framework.default_main_program()
    from paddle_tpu_torch.fluid.ir_pass import vjp_snapshot_key
    blk = program.desc.global_block
    ops = list(blk.ops)

    def _var(name):
        return blk.var(name) if name and blk.has_var(name) else None

    def activation4(name):
        v = _var(name)
        return (v is not None and v.shape is not None and len(v.shape) == 4
                and v.dtype.startswith(("float", "bfloat"))
                and not v.persistable and not v.is_parameter)

    def rank4_var(name):
        v = _var(name)
        return v is not None and v.shape is not None and len(v.shape) == 4

    producers = [n for op in ops for names in op.outputs.values()
                 for n in names]
    # optimistic: every produced rank-4 activation starts resident; feed
    # vars (no producer) stay NCHW and the first conv converts them
    nhwc = {n: True for n in producers if activation4(n)}

    def falsify(names):
        changed = False
        for n in names:
            if nhwc.get(n):
                nhwc[n] = False
                changed = True
        return changed

    def group_all_or_none(names):
        """The named rank-4 vars share one layout; a rank-4 var outside
        ``nhwc`` (a feed, a parameter) is NCHW and falsifies the group."""
        present = [n for n in names if n in nhwc]
        fixed_nchw = any(n not in nhwc and rank4_var(n) for n in names if n)
        if present and (fixed_nchw or not all(nhwc[n] for n in present)):
            return falsify(present)
        return False

    def constrain_op(op):
        t = op.type
        if t in CONVERT_SLOTS or t == "__vjp__":
            return False
        ins = [n for names in op.inputs.values() for n in names]
        outs = [n for names in op.outputs.values() for n in names]
        if t in AGNOSTIC:
            return group_all_or_none(ins + outs)
        if t == "concat":
            if op.attrs.get("axis", 0) == 1:
                return group_all_or_none(ins + outs)
            return falsify(ins + outs)
        if t in ELEMENTWISE:
            x = (op.inputs.get("X") or [None])[0]
            y = (op.inputs.get("Y") or [None])[0]
            o = (op.outputs.get("Out") or [None])[0]
            kind = _op_bcast_kind(op, _var)
            if kind in ("scalar", "chan", "bc"):
                return group_all_or_none([x, o])
            if kind is None:
                return falsify([x, o])
            return group_all_or_none([x, y, o])
        return falsify(ins + outs)

    def run_fixpoint():
        changed = True
        while changed:
            changed = False
            for op in ops:
                changed |= constrain_op(op)

    run_fixpoint()
    # a gradient var that must stay NCHW while its forward var is resident
    # would disagree with the layout its __vjp__ gives it: falsify the
    # forward var and run again until consistent (``:180-198``)
    while True:
        conflicted = False
        for n in list(nhwc):
            if "@GRAD" in n and not nhwc[n]:
                fwd = n.split("@GRAD")[0]
                if nhwc.get(fwd):
                    nhwc[fwd] = False
                    conflicted = True
        if not conflicted:
            break
        run_fixpoint()

    tags = {}
    for oi, op in enumerate(ops):
        t = op.type
        if t in CONVERT_SLOTS:
            in_slot, out_slot = CONVERT_SLOTS[t]
            xin = (op.inputs.get(in_slot) or [None])[0]
            xout = (op.outputs.get(out_slot) or [None])[0]
            in_ready = bool(nhwc.get(xin))
            out_keep = bool(nhwc.get(xout))
            if in_ready or out_keep:
                tags[oi] = {"__nhwc__": True, "__nhwc_in_ready__": in_ready,
                            "__nhwc_out_keep__": out_keep}
            if t == "conv2d_fusion":
                resid = (op.inputs.get("ResidualData") or [None])[0]
                if resid is not None and (nhwc.get(resid) or oi in tags):
                    tags.setdefault(oi, {})["__nhwc_resid_ready__"] = \
                        bool(nhwc.get(resid))
        elif t in ELEMENTWISE:
            x = (op.inputs.get("X") or [None])[0]
            kind = _op_bcast_kind(op, _var)
            if nhwc.get(x) and kind == "chan":
                tags[oi] = {"__nhwc_bcast__": True}
            elif nhwc.get(x) and kind == "bc":
                tags[oi] = {"__nhwc_bcast_bc__": True}
        elif t == "concat":
            first_in = (op.inputs.get("X") or [None])[0]
            if nhwc.get(first_in) and op.attrs.get("axis", 0) == 1:
                tags[oi] = {"__nhwc_concat__": True}
    for oi, attrs in tags.items():
        ops[oi].attrs.update(attrs)
    # residency on the var descs; a gradient var's is its forward var's
    for n in list(nhwc):
        if "@GRAD" in n:
            nhwc[n] = bool(nhwc.get(n.split("@GRAD")[0]))
    for n, resident in nhwc.items():
        if resident:
            blk.var(n).attrs["__nhwc__"] = True
    snap_tags = {vjp_snapshot_key(ops[oi].type, ops[oi].outputs): t_attrs
                 for oi, t_attrs in tags.items()}
    for op in ops:
        if op.type == "__vjp__":
            snap = op.attrs.get("fwd_op", {})
            key = vjp_snapshot_key(snap.get("type"), snap.get("outputs"))
            if key in snap_tags:
                snap.setdefault("attrs", {}).update(snap_tags[key])
    program.desc.bump_version()
    return len(tags)
