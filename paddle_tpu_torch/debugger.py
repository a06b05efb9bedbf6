"""Program visualization & debugging (reference:
python/paddle/fluid/debugger.py — draw_block_graphviz).

Emits Graphviz .dot for a block: ops as boxes, variables as ellipses
(parameters highlighted), with def-use edges.  ``repr_program`` gives a
compact text dump (op list with inputs→outputs) for terminals without dot.
A copy of the JAX package's ``debugger.py``: the same text for the same
Program.
"""
from __future__ import annotations

__all__ = ["draw_block_graphviz", "repr_program"]


def _esc(s):
    return str(s).replace('"', '\\"')


def draw_block_graphviz(block, highlights=None, path="./temp.dot"):
    """Write a .dot graph of ``block`` (reference debugger.py:24)."""
    highlights = set(highlights or [])
    lines = ["digraph G {", "  rankdir=TB;"]
    seen_vars = set()
    for name, var in block.vars.items():
        shape_txt = "" if var.shape is None else str(list(var.shape))
        color = 'style=filled, fillcolor="lightblue"' if getattr(var, "trainable", None) else ""
        if name in highlights:
            color = 'style=filled, fillcolor="orange"'
        lines.append(
            '  "var_%s" [label="%s\\n%s %s", shape=ellipse, %s];'
            % (_esc(name), _esc(name), _esc(var.dtype), _esc(shape_txt), color)
        )
        seen_vars.add(name)
    for i, op in enumerate(block.ops):
        lines.append('  "op_%d" [label="%s", shape=box, style=filled, fillcolor="gray90"];' % (i, _esc(op.type)))
        for names in op.inputs.values():
            for n in names:
                if n in seen_vars:
                    lines.append('  "var_%s" -> "op_%d";' % (_esc(n), i))
        for names in op.outputs.values():
            for n in names:
                if n in seen_vars:
                    lines.append('  "op_%d" -> "var_%s";' % (i, _esc(n)))
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def repr_program(program):
    """Compact text dump: one line per op, per block."""
    out = []
    for blk in program.blocks:
        out.append("block %d (parent %d):" % (blk.idx, blk.parent_idx))
        for op in blk.ops:
            ins = ", ".join("%s=%s" % (k, v) for k, v in op.inputs.items())
            outs = ", ".join("%s=%s" % (k, v) for k, v in op.outputs.items())
            out.append("  %-24s (%s) -> (%s)" % (op.type, ins, outs))
    return "\n".join(out)
