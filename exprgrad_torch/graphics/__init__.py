"""Visualization helpers (DOT graph export)."""

from .canvas import Canvas, GridLayout
from .dotgraph import to_dot_graph

__all__ = ["Canvas", "GridLayout", "to_dot_graph"]
