"""Program -> Graphviz drawing (reference: python/paddle/fluid/net_drawer.py,
a thin CLI over graphviz).  Delegates to debugger.draw_block_graphviz.
A copy of the JAX package's ``net_drawer.py``."""
from __future__ import annotations

from .debugger import draw_block_graphviz

__all__ = ["draw_graph", "draw_block_graphviz"]


def draw_graph(startup_program, main_program, path="./network.dot", **kwargs):
    """Render main_program's global block (the reference CLI merged both
    programs into one picture; startup adds only init ops)."""
    return draw_block_graphviz(main_program.global_block(), path=path)
