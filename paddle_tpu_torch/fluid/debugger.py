"""Program visualization (the port's copy of ``draw_block_graphviz`` from
``paddle_tpu/fluid/debugger.py``; reference: python/paddle/fluid/
debugger.py, framework/ir/graph_viz_pass.cc FLAGS_debug_graphviz_path)."""

from __future__ import annotations

from typing import Optional

_OP_STYLE = 'shape=box, style="rounded,filled", fillcolor="#E6F2FF"'
_VAR_STYLE = 'shape=oval, style=filled, fillcolor="#EFEFEF"'
_PARAM_STYLE = 'shape=oval, style=filled, fillcolor="#DFF7DF"'


def draw_block_graphviz(block, highlights=None, path: Optional[str] = None):
    """The graphviz dot source of a BlockDesc's dataflow (persistables
    green, ``highlights`` red); written to ``path`` when given."""
    highlights = set(highlights or [])
    lines = ["digraph G {", "  rankdir=TB;"]
    seen_vars = {}

    def var_node(name):
        if name in seen_vars:
            return seen_vars[name]
        nid = f"var_{len(seen_vars)}"
        seen_vars[name] = nid
        style = _VAR_STYLE
        if block.has_var(name):
            vd = block.var(name)
            if getattr(vd, "persistable", False):
                style = _PARAM_STYLE
            label = f"{name}\\n{vd.shape or ''} {vd.dtype}"
        else:
            label = name
        if name in highlights:
            style += ', color=red, penwidth=2'
        lines.append(f'  {nid} [label="{label}", {style}];')
        return nid

    for i, op in enumerate(block.ops):
        op_id = f"op_{i}"
        lines.append(f'  {op_id} [label="{op.type}", {_OP_STYLE}];')
        for names in op.inputs.values():
            for n in names:
                lines.append(f"  {var_node(n)} -> {op_id};")
        for names in op.outputs.values():
            for n in names:
                lines.append(f"  {op_id} -> {var_node(n)};")
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot
