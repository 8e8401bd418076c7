"""Graph IR and the inference passes of the port (its own copy of
``paddle_tpu/fluid/ir_pass.py``; reference: framework/ir/ -- Graph/Node
ir/graph.h ir/node.h, Pass/PassRegistry ir/pass.h, PassBuilder
ir/pass_builder.cc, GraphPatternDetector ir/graph_pattern_detector.cc and
the fusion passes).

The passes are program rewrites: given the same program and the same
scope values they leave the same ``ProgramDesc.to_dict()`` as the JAX
package's. The :class:`Graph` is a live view over a ``BlockDesc``:
mutations write through, and ``graph_to_program_pass`` is the identity.

The three passes that read the scope (``conv_bn_fuse_pass`` through
``inference/transpiler.py``, ``conv_affine_channel_fuse_pass`` and
``embedding_fc_lstm_fuse_pass``) fold on the host in numpy float32, as
the reference does, and write the results back as tensors on the device
of the value they read (:func:`host_array`, :func:`put_like`), so a
folded weight is bit-equal to the JAX package's.

:func:`vjp_snapshot_key` (``:494-503``) pairs a forward op with its
``__vjp__`` snapshot by (type, outputs); ``contrib/layout.py`` mirrors its
tags into the snapshots through it. Not ported:
``fuse_elewise_add_act_pass`` and the other ``vjp_*`` helpers
(``:506-521``, ``:892``). They rewrite the ``__vjp__`` ops of training
programs, which the port runs (``ops/grad_ops.py``); they come with
ROADMAP A6.10.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.core import ir


def host_array(value) -> np.ndarray:
    """A scope value (a torch tensor on any device, or an array) as a
    numpy array on the host, its dtype kept."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def put_like(like, array: np.ndarray):
    """``array`` as a tensor on the device of scope value ``like`` (the
    CPU for a host array)."""
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.from_numpy(np.ascontiguousarray(array)).to(dev)


class Node:
    """reference: ir/node.h -- either an op node or a var node."""

    def __init__(self, kind: str, name: str, op: Optional[ir.OpDesc] = None):
        self.kind = kind              # "op" | "var"
        self.name = name
        self.op = op
        self.inputs: List["Node"] = []
        self.outputs: List["Node"] = []

    def is_op(self):
        return self.kind == "op"

    def __repr__(self):
        return f"Node({self.kind}:{self.name})"


class Graph:
    """Dataflow view over a BlockDesc (reference: ir/graph.h); mutations
    write through to the block."""

    def __init__(self, block: ir.BlockDesc):
        self.block = block
        self.rebuild()

    def rebuild(self):
        self.op_nodes: List[Node] = []
        self.var_nodes: Dict[str, Node] = {}
        for i, op in enumerate(self.block.ops):
            onode = Node("op", f"{op.type}#{i}", op)
            self.op_nodes.append(onode)
            for names in op.inputs.values():
                for n in names:
                    vn = self.var_nodes.setdefault(n, Node("var", n))
                    onode.inputs.append(vn)
                    vn.outputs.append(onode)
            for names in op.outputs.values():
                for n in names:
                    vn = self.var_nodes.setdefault(n, Node("var", n))
                    onode.outputs.append(vn)
                    vn.inputs.append(onode)

    def producer(self, var_name: str) -> Optional[Node]:
        vn = self.var_nodes.get(var_name)
        return vn.inputs[-1] if vn and vn.inputs else None

    def consumers(self, var_name: str) -> List[Node]:
        vn = self.var_nodes.get(var_name)
        return list(vn.outputs) if vn else []

    def remove_ops(self, ops: List[ir.OpDesc]):
        drop = {id(o) for o in ops}
        self.block.ops[:] = [o for o in self.block.ops
                             if id(o) not in drop]
        self.rebuild()


class PatternDetector:
    """Linear-chain pattern matcher (the working core of the reference's
    GraphPatternDetector: every fusion pass here matches a chain)."""

    def __init__(self, graph: Graph):
        self.graph = graph

    def match_chain(self, op_types: List[str], single_use: bool = True):
        """Lists of OpDescs [op0, op1, ...] where op_i's output feeds
        op_{i+1} and (with ``single_use``) has no other consumer. The
        reference's ``ignore_vjp`` belongs to the training passes, which
        are not ported."""
        matches = []
        for node in self.graph.op_nodes:
            if node.op.type != op_types[0]:
                continue
            chain = [node]
            ok = True
            for want in op_types[1:]:
                nxt = None
                for v in chain[-1].outputs:
                    cons = v.outputs
                    if single_use and len(cons) != 1:
                        continue
                    if cons and cons[0].op.type == want:
                        nxt = cons[0]
                        break
                if nxt is None:
                    ok = False
                    break
                chain.append(nxt)
            if ok:
                matches.append([n.op for n in chain])
        return matches


class Pass:
    """reference: ir/pass.h -- apply(graph) -> graph, mutating in place."""

    name = "pass"

    def apply(self, graph: Graph) -> Graph:
        raise NotImplementedError

    def __call__(self, graph: Graph) -> Graph:
        return self.apply(graph) or graph


_PASS_REGISTRY: Dict[str, Callable[[], Pass]] = {}


def register_pass(name: str):
    """reference: REGISTER_PASS (ir/pass.h)."""
    def deco(cls):
        cls.name = name
        _PASS_REGISTRY[name] = cls
        return cls
    return deco


def get_pass(name: str) -> Pass:
    if name not in _PASS_REGISTRY:
        raise KeyError(f"no pass {name!r}; registered: "
                       f"{sorted(_PASS_REGISTRY)}")
    return _PASS_REGISTRY[name]()


class PassBuilder:
    """Ordered pass pipeline (reference: ir/pass_builder.cc)."""

    def __init__(self, passes: Optional[List[str]] = None):
        self._names = list(passes or [])

    def append_pass(self, name: str):
        self._names.append(name)
        return self

    def insert_pass(self, idx: int, name: str):
        self._names.insert(idx, name)
        return self

    def remove_pass(self, idx: int):
        self._names.pop(idx)
        return self

    def all_passes(self):
        return list(self._names)

    def apply(self, program, scope=None, place=None):
        graph = Graph(program.desc.global_block)
        for name in self._names:
            p = get_pass(name)
            if hasattr(p, "scope"):
                p.scope = scope
            graph = p(graph)
        program.desc.bump_version()
        return graph


def _bias_shaped(block, name) -> bool:
    """Var ``name`` is declared with at most one non-unit dim."""
    vd = block.var(name) if name and block.has_var(name) else None
    shape = list(vd.shape or []) if vd is not None else []
    return len([d for d in shape if d != 1]) <= 1


@register_pass("fc_fuse_pass")
class FcFusePass(Pass):
    """mul + elementwise_add (+relu) -> fc (reference:
    ir/fc_fuse_pass.cc): the add's X is the product and its Y a bias."""

    def apply(self, graph: Graph) -> Graph:
        det = PatternDetector(graph)
        fused = []
        for ops in (det.match_chain(["mul", "elementwise_add", "relu"])
                    + det.match_chain(["mul", "elementwise_add"])):
            mul, add = ops[0], ops[1]
            if id(mul) in {id(o) for f in fused for o in f}:
                continue
            relu = ops[2] if len(ops) == 3 else None
            if mul.attrs.get("y_num_col_dims", 1) != 1:
                continue
            if add.inputs.get("X", [None])[0] != mul.outputs["Out"][0]:
                continue
            bias_name = add.inputs.get("Y", [None])[0]
            if bias_name is None or not _bias_shaped(graph.block, bias_name):
                continue
            out = (relu or add).outputs["Out"][0]
            fc = ir.OpDesc(
                type="fc",
                inputs={"Input": list(mul.inputs["X"]),
                        "W": list(mul.inputs["Y"]),
                        "Bias": list(add.inputs["Y"])},
                outputs={"Out": [out]},
                attrs={"in_num_col_dims": mul.attrs.get("x_num_col_dims", 1),
                       "activation_type": "relu" if relu else ""})
            idx = graph.block.ops.index(mul)
            graph.block.ops[idx] = fc
            graph.remove_ops([add] + ([relu] if relu else []))
            fused.append(ops)
        return graph


@register_pass("conv_bn_fuse_pass")
class ConvBnFusePass(Pass):
    """conv + batch_norm statistic folding (reference:
    ir/conv_bn_fuse_pass.cc): the inference transpiler's numeric fold
    over the scope's statistics."""

    scope = None

    def apply(self, graph: Graph) -> Graph:
        from paddle_tpu_torch.inference.transpiler import InferenceTranspiler
        InferenceTranspiler().fold_block(graph.block, self.scope)
        graph.rebuild()
        return graph


@register_pass("graph_viz_pass")
class GraphVizPass(Pass):
    """reference: ir/graph_viz_pass.cc + FLAGS_debug_graphviz_path: the
    block's dot source written to ``path`` (or the flag's path)."""

    path: Optional[str] = None

    def apply(self, graph: Graph) -> Graph:
        from paddle_tpu_torch import flags
        from paddle_tpu_torch.fluid import debugger
        path = self.path or flags.get("debug_graphviz_path") or None
        if path:
            debugger.draw_block_graphviz(graph.block, path=path)
        return graph


@register_pass("graph_to_program_pass")
class GraphToProgramPass(Pass):
    """reference: ir/graph_to_program_pass.cc -- the Graph IS a live block
    view, so the round trip is the identity."""

    def apply(self, graph: Graph) -> Graph:
        return graph


@register_pass("seqconv_eltadd_relu_fuse_pass")
class SeqconvEltaddReluFusePass(Pass):
    """sequence_conv + elementwise_add(bias) + relu ->
    fusion_seqconv_eltadd_relu (reference:
    ir/seqconv_eltadd_relu_fuse_pass.cc)."""

    def apply(self, graph: Graph) -> Graph:
        det = PatternDetector(graph)
        for conv, add, relu in det.match_chain(
                ["sequence_conv", "elementwise_add", "relu"]):
            if add.inputs.get("X", [None])[0] != conv.outputs["Out"][0]:
                continue
            bias = add.inputs.get("Y", [None])[0]
            if bias is None or not _bias_shaped(graph.block, bias):
                continue
            fused = ir.OpDesc(
                type="fusion_seqconv_eltadd_relu",
                inputs={"X": list(conv.inputs["X"]),
                        "Filter": list(conv.inputs["Filter"]),
                        "Bias": [bias],
                        **({"SeqLens": list(conv.inputs["SeqLens"])}
                           if conv.inputs.get("SeqLens") else {})},
                outputs={"Out": [relu.outputs["Out"][0]]},
                attrs=dict(conv.attrs))
            idx = graph.block.ops.index(conv)
            graph.block.ops[idx] = fused
            graph.remove_ops([add, relu])
        return graph


@register_pass("fc_lstm_fuse_pass")
class FcLstmFusePass(Pass):
    """mul (the gate projection) [+ elementwise_add bias] + dynamic_lstm
    -> fusion_lstm (reference: ir/fc_lstm_fuse_pass.cc). A projection
    bias next to the LSTM's own gate bias is left alone: the fused op
    has one Bias slot."""

    def apply(self, graph: Graph) -> Graph:
        det = PatternDetector(graph)
        candidates = (det.match_chain(
            ["mul", "elementwise_add", "dynamic_lstm"])
            + det.match_chain(["mul", "dynamic_lstm"]))
        seen = set()
        for ops in candidates:
            mul = ops[0]
            if id(mul) in seen:
                continue
            lstm = ops[-1]
            add = ops[1] if len(ops) == 3 else None
            proj_out = (add or mul).outputs["Out"][0]
            if lstm.inputs.get("Input", [None])[0] != proj_out:
                continue
            bias = None
            if add is not None:
                if lstm.inputs.get("Bias"):
                    continue   # two gate biases
                if add.inputs.get("X", [None])[0] != mul.outputs["Out"][0]:
                    continue
                bias = add.inputs.get("Y", [None])[0]
                # an undeclared Y is not a bias (the reference's [0, 0])
                if not (bias and graph.block.has_var(bias)
                        and _bias_shaped(graph.block, bias)):
                    continue
            elif lstm.inputs.get("Bias"):
                bias = lstm.inputs["Bias"][0]
            ins = {"X": list(mul.inputs["X"]),
                   "WeightX": list(mul.inputs["Y"]),
                   "WeightH": list(lstm.inputs["Weight"])}
            if bias:
                ins["Bias"] = [bias]
            for slot in ("SeqLens", "H0", "C0"):
                if lstm.inputs.get(slot):
                    ins[slot] = list(lstm.inputs[slot])
            fused = ir.OpDesc(
                type="fusion_lstm", inputs=ins,
                outputs={"Hidden": list(lstm.outputs["Hidden"]),
                         **({"Cell": list(lstm.outputs["Cell"])}
                            if lstm.outputs.get("Cell") else {})},
                attrs=dict(lstm.attrs))
            idx = graph.block.ops.index(mul)
            graph.block.ops[idx] = fused
            graph.remove_ops(([add] if add else []) + [lstm])
            seen.add(id(mul))
        return graph


@register_pass("embedding_fc_lstm_fuse_pass")
class EmbeddingFcLstmFusePass(Pass):
    """lookup_table + mul + dynamic_lstm -> fused_embedding_fc_lstm
    (reference: ir/embedding_fc_lstm_fuse_pass.cc): the table is
    pre-multiplied by the gate projection from the scope's values
    (``W_combined = table @ Wx``, numpy float32 on the host), so the op
    gathers [V, 4D] rows instead of gather + product."""

    scope = None

    def apply(self, graph: Graph) -> Graph:
        if self.scope is None:
            return graph
        det = PatternDetector(graph)
        for emb, mul, lstm in det.match_chain(
                ["lookup_table", "mul", "dynamic_lstm"]):
            if lstm.inputs.get("Input", [None])[0] != \
                    mul.outputs["Out"][0]:
                continue
            if mul.inputs.get("X", [None])[0] != emb.outputs["Out"][0]:
                continue
            pad = emb.attrs.get("padding_idx", -1)
            if pad is not None and pad >= 0:
                # the combined table cannot zero the pad rows after the
                # lookup (combined[pad] = table[pad] @ Wx != 0)
                continue
            table = emb.inputs["W"][0]
            wx = mul.inputs["Y"][0]
            tv, wv = self.scope.find_var(table), self.scope.find_var(wx)
            if tv is None or wv is None:
                continue
            combined_name = f"{table}__matmul__{wx}"
            combined = (np.asarray(host_array(tv), np.float32)
                        @ np.asarray(host_array(wv), np.float32))
            graph.block.add_var(ir.VarDesc(
                name=combined_name, shape=list(combined.shape),
                dtype="float32", persistable=True))
            self.scope.set_var(combined_name, put_like(tv, combined))
            ins = {"Ids": list(emb.inputs["Ids"]),
                   "Embeddings": [combined_name],
                   "WeightH": list(lstm.inputs["Weight"])}
            for slot in ("Bias", "SeqLens", "H0", "C0"):
                if lstm.inputs.get(slot):
                    ins[slot] = list(lstm.inputs[slot])
            fused = ir.OpDesc(
                type="fused_embedding_fc_lstm", inputs=ins,
                outputs={"Hidden": list(lstm.outputs["Hidden"]),
                         **({"Cell": list(lstm.outputs["Cell"])}
                            if lstm.outputs.get("Cell") else {})},
                attrs=dict(lstm.attrs))
            idx = graph.block.ops.index(emb)
            graph.block.ops[idx] = fused
            graph.remove_ops([mul, lstm])
        return graph


def _bias_like(block, name, want_axis=None, axis=None):
    """Var ``name`` is bias-shaped (<= 1 non-unit dim) and, with
    ``want_axis``, lies on that axis: a rank-1 bias by the elementwise
    ``axis`` attr, a higher-rank one by the place of its one non-unit
    dim (a [1, 1, 1, W] add is not a channel bias)."""
    if name is None:
        return False
    vd = block.var(name) if block.has_var(name) else None
    if vd is None:
        return False
    sh = list(vd.shape or [])
    if len([d for d in sh if d != 1]) > 1:
        return False
    if want_axis is not None:
        if len(sh) == 1:
            return axis == want_axis
        nonunit = [i for i, d in enumerate(sh) if d != 1]
        return not nonunit or nonunit[0] == want_axis
    return True


def _alive(graph, ops):
    """Matches are computed up front and may share ops (both ResNet
    branches end in one residual add + relu): a match whose ops were
    already fused is stale."""
    cur = {id(o) for o in graph.block.ops}
    return all(id(o) in cur for o in ops)


def vjp_snapshot_key(op_type, outputs):
    """The identity that pairs a forward op with its ``__vjp__`` backward
    snapshot: (type, sorted outputs). Output names are unique in a block,
    so it survives a pass that reorders or renumbers the ops, where
    ``fwd_op_index`` goes stale."""
    return (op_type, tuple(sorted((s, tuple(n)) for s, n in
                                  (outputs or {}).items())))


def _first_out(op):
    for names in op.outputs.values():
        if names:
            return names[0]
    return None


_CONV_ACTS = ("relu", "sigmoid", "tanh")


class _ConvEltwiseFuseBase(Pass):
    """conv2d + elementwise_add [+ residual add] [+ act] -> conv2d_fusion
    (reference: ir/conv_elementwise_add_fuse_pass.cc,
    conv_elementwise_add_act_fuse_pass.cc,
    conv_elementwise_add2_act_fuse_pass.cc). NCHW only: the bias is a
    channel-dim-1 epilogue."""

    with_act = False
    with_residual = False

    def apply(self, graph: Graph) -> Graph:
        det = PatternDetector(graph)
        chain = ["conv2d", "elementwise_add"]
        if self.with_residual:
            chain.append("elementwise_add")
        pats = []
        if self.with_act:
            for a in _CONV_ACTS:
                pats += det.match_chain(chain + [a])
        else:
            pats = det.match_chain(chain)
        fused_ids = set()
        for ops in pats:
            conv, add = ops[0], ops[1]
            if id(conv) in fused_ids or not _alive(graph, ops):
                continue
            if conv.attrs.get("data_format", "NCHW") not in ("NCHW",
                                                             "AnyLayout"):
                continue
            if add.inputs.get("X", [None])[0] != conv.outputs["Output"][0]:
                continue
            bias = add.inputs.get("Y", [None])[0]
            if not _bias_like(graph.block, bias, want_axis=1,
                              axis=add.attrs.get("axis", -1)):
                continue
            resid = None
            rest = ops[2:]
            if self.with_residual:
                add2, rest = rest[0], rest[1:]
                xs = add2.inputs.get("X", [None])[0]
                ys = add2.inputs.get("Y", [None])[0]
                prev_out = add.outputs["Out"][0]
                resid = ys if xs == prev_out else xs
                if resid is None or resid == prev_out:
                    continue
                if _bias_like(graph.block, resid):
                    continue   # a second per-channel bias, not a residual
            act = rest[0].type if rest else ""
            last = rest[0] if rest else (ops[2] if self.with_residual
                                         else add)
            ins = {"Input": list(conv.inputs["Input"]),
                   "Filter": list(conv.inputs["Filter"]),
                   "Bias": [bias]}
            if resid:
                ins["ResidualData"] = [resid]
            fused = ir.OpDesc(
                type="conv2d_fusion", inputs=ins,
                outputs={"Output": [_first_out(last)]},
                attrs={**conv.attrs, "activation": act or "identity"})
            # at the chain's TAIL: every input (a residual produced
            # between the conv and the act included) is defined by then
            idx = graph.block.ops.index(ops[-1])
            graph.block.ops[idx] = fused
            graph.remove_ops(list(ops[:-1]))
            fused_ids.add(id(conv))
        return graph


@register_pass("conv_elementwise_add_fuse_pass")
class ConvElementwiseAddFusePass(_ConvEltwiseFuseBase):
    """reference: ir/conv_elementwise_add_fuse_pass.cc."""


@register_pass("conv_elementwise_add_act_fuse_pass")
class ConvElementwiseAddActFusePass(_ConvEltwiseFuseBase):
    """reference: ir/conv_elementwise_add_act_fuse_pass.cc."""
    with_act = True


@register_pass("conv_elementwise_add2_act_fuse_pass")
class ConvElementwiseAdd2ActFusePass(_ConvEltwiseFuseBase):
    """conv + bias add + residual add + act (reference:
    ir/conv_elementwise_add2_act_fuse_pass.cc)."""
    with_act = True
    with_residual = True


@register_pass("conv_affine_channel_fuse_pass")
class ConvAffineChannelFusePass(Pass):
    """conv2d + affine_channel -> conv2d_fusion with the per-channel
    scale folded into the filter (reference:
    ir/conv_affine_channel_fuse_pass.cc; a fold over the scope's values,
    like conv_bn)."""

    scope = None

    def apply(self, graph: Graph) -> Graph:
        if self.scope is None:
            return graph
        det = PatternDetector(graph)
        for conv, ac in det.match_chain(["conv2d", "affine_channel"]):
            if ac.inputs.get("X", [None])[0] != conv.outputs["Output"][0]:
                continue
            if conv.attrs.get("data_format", "NCHW") not in ("NCHW",
                                                             "AnyLayout"):
                continue
            w_name = conv.inputs["Filter"][0]
            if len(graph.consumers(w_name)) != 1:
                continue   # folding would change another conv's filter
            scale_n = ac.inputs["Scale"][0]
            bias_n = ac.inputs["Bias"][0]
            wv = self.scope.find_var(w_name)
            sv = self.scope.find_var(scale_n)
            if wv is None or sv is None:
                continue
            w = np.asarray(host_array(wv), np.float32)
            s = np.asarray(host_array(sv), np.float32).reshape(-1, 1, 1, 1)
            self.scope.set_var(w_name, put_like(wv, (w * s).astype(w.dtype)))
            fused = ir.OpDesc(
                type="conv2d_fusion",
                inputs={"Input": list(conv.inputs["Input"]),
                        "Filter": [w_name], "Bias": [bias_n]},
                outputs={"Output": [ac.outputs["Out"][0]]},
                attrs={**conv.attrs, "activation": "identity"})
            idx = graph.block.ops.index(conv)
            graph.block.ops[idx] = fused
            graph.remove_ops([ac])
        return graph


@register_pass("fc_gru_fuse_pass")
class FcGruFusePass(Pass):
    """mul (gate projection) [+ elementwise_add bias] + dynamic_gru ->
    fusion_gru (reference: ir/fc_gru_fuse_pass.cc), the GRU mirror of
    fc_lstm_fuse_pass."""

    def apply(self, graph: Graph) -> Graph:
        det = PatternDetector(graph)
        candidates = (det.match_chain(["mul", "elementwise_add",
                                       "dynamic_gru"])
                      + det.match_chain(["mul", "dynamic_gru"]))
        seen = set()
        for ops in candidates:
            mul = ops[0]
            if id(mul) in seen or not _alive(graph, ops):
                continue
            gru = ops[-1]
            add = ops[1] if len(ops) == 3 else None
            proj_out = (add or mul).outputs["Out"][0]
            if gru.inputs.get("Input", [None])[0] != proj_out:
                continue
            bias = None
            if add is not None:
                if gru.inputs.get("Bias"):
                    continue   # two gate biases
                if add.inputs.get("X", [None])[0] != mul.outputs["Out"][0]:
                    continue
                bias = add.inputs.get("Y", [None])[0]
                if not _bias_like(graph.block, bias):
                    continue
            elif gru.inputs.get("Bias"):
                bias = gru.inputs["Bias"][0]
            ins = {"X": list(mul.inputs["X"]),
                   "WeightX": list(mul.inputs["Y"]),
                   "WeightH": list(gru.inputs["Weight"])}
            if bias:
                ins["Bias"] = [bias]
            for slot in ("SeqLens", "H0"):
                if gru.inputs.get(slot):
                    ins[slot] = list(gru.inputs[slot])
            fused = ir.OpDesc(
                type="fusion_gru", inputs=ins,
                outputs={"Hidden": list(gru.outputs["Hidden"])},
                attrs=dict(gru.attrs))
            idx = graph.block.ops.index(mul)
            graph.block.ops[idx] = fused
            graph.remove_ops(([add] if add else []) + [gru])
            seen.add(id(mul))
        return graph


@register_pass("seqpool_concat_fuse_pass")
class SeqpoolConcatFusePass(Pass):
    """N parallel SUM / AVERAGE / SQRT sequence_pool ops feeding one
    concat on axis 1 -> fusion_seqpool_concat (reference:
    ir/seqpool_concat_fuse_pass.cc)."""

    def apply(self, graph: Graph) -> Graph:
        for node in list(graph.op_nodes):
            cat = node.op
            if cat.type != "concat" or cat.attrs.get("axis", 0) != 1:
                continue
            pools = []
            for n in cat.inputs.get("X", []):
                prod = graph.producer(n)
                if (prod is None or prod.op.type != "sequence_pool"
                        or len(graph.consumers(n)) != 1):
                    pools = None
                    break
                pools.append(prod.op)
            if not pools or len(pools) < 2:
                continue
            ptypes = {str(p.attrs.get("pooltype", "AVERAGE")).upper()
                      for p in pools}
            if len(ptypes) != 1 or ptypes & {"MAX", "LAST", "FIRST"}:
                continue
            ins = {"X": [p.inputs["X"][0] for p in pools]}
            lens = [p.inputs.get("SeqLens", [None])[0] for p in pools]
            if any(n is not None for n in lens):
                if any(n is None for n in lens):
                    continue   # masked and unmasked pools: keep them
                ins["SeqLens"] = lens
            fused = ir.OpDesc(
                type="fusion_seqpool_concat", inputs=ins,
                outputs={"Out": list(cat.outputs["Out"])},
                attrs={"pooltype": ptypes.pop(),
                       "axis": cat.attrs.get("axis", 1)})
            idx = graph.block.ops.index(cat)   # the tail: every pool's
            graph.block.ops[idx] = fused       # input is defined there
            graph.remove_ops(pools)
        return graph


@register_pass("transpose_flatten_concat_fuse_pass")
class TransposeFlattenConcatFusePass(Pass):
    """N parallel transpose2 + flatten2 chains feeding one concat ->
    fusion_transpose_flatten_concat (reference:
    ir/transpose_flatten_concat_fuse_pass.cc)."""

    def apply(self, graph: Graph) -> Graph:
        for node in list(graph.op_nodes):
            cat = node.op
            if cat.type != "concat":
                continue
            chains = []
            for n in cat.inputs.get("X", []):
                fl = graph.producer(n)
                if (fl is None or fl.op.type != "flatten2"
                        or len(graph.consumers(n)) != 1):
                    chains = None
                    break
                tr = graph.producer(fl.op.inputs["X"][0])
                if (tr is None or tr.op.type != "transpose2"
                        or len(graph.consumers(fl.op.inputs["X"][0])) != 1):
                    chains = None
                    break
                chains.append((tr.op, fl.op))
            if not chains or len(chains) < 2:
                continue
            axes = {tuple(t.attrs.get("axis", [])) for t, _ in chains}
            flats = {f.attrs.get("axis", 1) for _, f in chains}
            if len(axes) != 1 or len(flats) != 1:
                continue
            fused = ir.OpDesc(
                type="fusion_transpose_flatten_concat",
                inputs={"X": [t.inputs["X"][0] for t, _ in chains]},
                outputs={"Out": list(cat.outputs["Out"])},
                attrs={"trans_axis": list(axes.pop()),
                       "flatten_axis": flats.pop(),
                       "concat_axis": cat.attrs.get("axis", 1)})
            idx = graph.block.ops.index(cat)
            graph.block.ops[idx] = fused
            graph.remove_ops([o for t, f in chains for o in (t, f)])
        return graph


@register_pass("seq_concat_fc_fuse_pass")
class SeqConcatFcFusePass(Pass):
    """concat(seq, sequence_expand(v_i)...) + mul [+ bias add] [+ act]
    -> fusion_seqexpand_concat_fc (reference:
    ir/seq_concat_fc_fuse_pass.cc). Only the unmasked form fuses: a
    sequence_expand with SeqLens zeroes padded steps, the fused op
    broadcasts without a mask."""

    def apply(self, graph: Graph) -> Graph:
        det = PatternDetector(graph)
        pats = (det.match_chain(["concat", "mul", "elementwise_add",
                                 "relu"])
                + det.match_chain(["concat", "mul", "elementwise_add",
                                   "sigmoid"])
                + det.match_chain(["concat", "mul", "elementwise_add",
                                   "tanh"])
                + det.match_chain(["concat", "mul", "elementwise_add"]))
        seen = set()
        for ops in pats:
            cat, mul = ops[0], ops[1]
            if id(cat) in seen or not _alive(graph, ops):
                continue
            add = ops[2] if len(ops) >= 3 else None
            act = ops[3].type if len(ops) == 4 else ""
            if mul.attrs.get("x_num_col_dims", 1) != 2:
                continue   # an fc over [B, T, D] features
            if mul.inputs.get("X", [None])[0] != cat.outputs["Out"][0]:
                continue
            if cat.attrs.get("axis", 0) not in (2, -1):
                continue
            bias = None
            if add is not None:
                if add.inputs.get("X", [None])[0] != mul.outputs["Out"][0]:
                    continue
                bias = add.inputs.get("Y", [None])[0]
                if not _bias_like(graph.block, bias):
                    continue
            xs = cat.inputs.get("X", [])
            if len(xs) < 2:
                continue
            expands, ok = [], True
            for n in xs[1:]:
                prod = graph.producer(n)
                if (prod is None or prod.op.type not in
                        ("sequence_expand", "sequence_expand_as")
                        or prod.op.inputs.get("SeqLens")
                        or len(graph.consumers(n)) != 1):
                    ok = False
                    break
                expands.append(prod.op)
            if not ok:
                continue
            ins = {"X": [xs[0]] + [e.inputs["X"][0] for e in expands],
                   "FCWeight": list(mul.inputs["Y"])}
            if bias:
                ins["FCBias"] = [bias]
            last = ops[-1]
            fused = ir.OpDesc(
                type="fusion_seqexpand_concat_fc", inputs=ins,
                outputs={"Out": [_first_out(last)]},
                attrs={"fc_activation": act or "identity"})
            idx = graph.block.ops.index(last)
            graph.block.ops[idx] = fused
            graph.remove_ops(expands + list(ops[:-1]))
            seen.add(id(cat))
        return graph


@register_pass("is_test_pass")
class IsTestPass(Pass):
    """Set is_test=True on the ops with a train / infer split
    (reference: ir/is_test_pass.cc, the same op list)."""

    OP_TYPES = ("batch_norm", "dropout", "lrn", "pool2d", "faster_rcnn",
                "while", "fake_quantize_abs_max",
                "fake_quantize_range_abs_max", "fake_dequantize_max_abs")

    def apply(self, graph: Graph) -> Graph:
        for node in graph.op_nodes:
            if node.op.type in self.OP_TYPES:
                node.op.attrs = dict(node.op.attrs)
                node.op.attrs["is_test"] = True
        return graph


@register_pass("infer_clean_graph_pass")
class InferCleanGraphPass(Pass):
    """Strip the feed / fetch plumbing ops from an inference program
    (reference: ir/infer_clean_graph_pass.cc)."""

    def apply(self, graph: Graph) -> Graph:
        drop = [n.op for n in graph.op_nodes
                if n.op.type in ("feed", "fetch")]
        if drop:
            graph.remove_ops(drop)
        return graph
