"""Minimal vector-graphics canvas with SVG output + grid layouts.

Parity: reference exprgrad/graphics/canvas.nim + layouts.nim (not used by
the compiler path; utility for figures).  The drawing model is retained-mode
shapes rendered to SVG; ``GridLayout`` arranges child canvases in rows and
columns for side-by-side figures (e.g. training-curve panels, rendered
target vs. prediction images).
"""

from __future__ import annotations

import base64
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


@dataclass
class _Shape:
    kind: str
    attrs: dict


@dataclass
class Canvas:
    width: float
    height: float
    background: Optional[str] = None
    shapes: list[_Shape] = field(default_factory=list)

    # --- drawing ------------------------------------------------------
    def line(self, x1, y1, x2, y2, color="black", width=1.0) -> None:
        self.shapes.append(_Shape("line", dict(
            x1=x1, y1=y1, x2=x2, y2=y2, stroke=color, sw=width
        )))

    def rect(self, x, y, w, h, fill="none", stroke="black", sw=1.0) -> None:
        self.shapes.append(_Shape("rect", dict(
            x=x, y=y, w=w, h=h, fill=fill, stroke=stroke, sw=sw
        )))

    def circle(self, cx, cy, r, fill="black", stroke="none") -> None:
        self.shapes.append(_Shape("circle", dict(
            cx=cx, cy=cy, r=r, fill=fill, stroke=stroke
        )))

    def text(self, x, y, content, size=12.0, color="black",
             anchor="start") -> None:
        self.shapes.append(_Shape("text", dict(
            x=x, y=y, content=content, size=size, color=color, anchor=anchor
        )))

    def polyline(self, points: Sequence[tuple], color="black",
                 width=1.0) -> None:
        self.shapes.append(_Shape("polyline", dict(
            points=list(points), stroke=color, sw=width
        )))

    def image(self, x, y, w, h, pixels: np.ndarray) -> None:
        """Embed a uint8 grayscale or RGB image (PNG-free: PPM data URI)."""
        from ..io.ppm import save_ppm
        import io as _io, tempfile, os

        pixels = np.asarray(pixels, dtype=np.uint8)
        # encode as PPM bytes
        if pixels.ndim == 2:
            header = f"P5\n{pixels.shape[1]} {pixels.shape[0]}\n255\n"
        else:
            header = f"P6\n{pixels.shape[1]} {pixels.shape[0]}\n255\n"
        data = header.encode() + pixels.tobytes()
        uri = "data:image/x-portable-pixmap;base64," + base64.b64encode(
            data
        ).decode()
        self.shapes.append(_Shape("image", dict(x=x, y=y, w=w, h=h, uri=uri)))

    # --- charts -------------------------------------------------------
    def plot(self, values: Sequence[float], color="#1f77b4",
             margin: float = 20.0, label: str = "") -> None:
        """Simple line plot of a series filling the canvas."""
        values = np.asarray(values, dtype=np.float64)
        if values.size < 2:
            return
        lo, hi = float(values.min()), float(values.max())
        span = (hi - lo) or 1.0
        w = self.width - 2 * margin
        h = self.height - 2 * margin
        points = [
            (
                margin + w * i / (values.size - 1),
                margin + h * (1.0 - (v - lo) / span),
            )
            for i, v in enumerate(values)
        ]
        self.rect(margin, margin, w, h, stroke="#cccccc")
        self.polyline(points, color=color, width=1.5)
        if label:
            self.text(margin + 4, margin + 14, label, size=11)

    # --- rendering ----------------------------------------------------
    def to_svg(self) -> str:
        out = [
            f'<svg xmlns="http://www.w3.org/2000/svg" '
            f'width="{self.width:g}" height="{self.height:g}" '
            f'viewBox="0 0 {self.width:g} {self.height:g}">'
        ]
        if self.background:
            out.append(
                f'<rect width="100%" height="100%" fill="{self.background}"/>'
            )
        for s in self.shapes:
            a = s.attrs
            if s.kind == "line":
                out.append(
                    f'<line x1="{a["x1"]:g}" y1="{a["y1"]:g}" x2="{a["x2"]:g}" '
                    f'y2="{a["y2"]:g}" stroke="{a["stroke"]}" '
                    f'stroke-width="{a["sw"]:g}"/>'
                )
            elif s.kind == "rect":
                out.append(
                    f'<rect x="{a["x"]:g}" y="{a["y"]:g}" width="{a["w"]:g}" '
                    f'height="{a["h"]:g}" fill="{a["fill"]}" '
                    f'stroke="{a["stroke"]}" stroke-width="{a["sw"]:g}"/>'
                )
            elif s.kind == "circle":
                out.append(
                    f'<circle cx="{a["cx"]:g}" cy="{a["cy"]:g}" r="{a["r"]:g}" '
                    f'fill="{a["fill"]}" stroke="{a["stroke"]}"/>'
                )
            elif s.kind == "text":
                out.append(
                    f'<text x="{a["x"]:g}" y="{a["y"]:g}" '
                    f'font-size="{a["size"]:g}" fill="{a["color"]}" '
                    f'text-anchor="{a["anchor"]}">{a["content"]}</text>'
                )
            elif s.kind == "polyline":
                pts = " ".join(f"{x:g},{y:g}" for x, y in a["points"])
                out.append(
                    f'<polyline points="{pts}" fill="none" '
                    f'stroke="{a["stroke"]}" stroke-width="{a["sw"]:g}"/>'
                )
            elif s.kind == "image":
                out.append(
                    f'<image x="{a["x"]:g}" y="{a["y"]:g}" width="{a["w"]:g}" '
                    f'height="{a["h"]:g}" href="{a["uri"]}"/>'
                )
        out.append("</svg>")
        return "\n".join(out)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_svg())


@dataclass
class GridLayout:
    """Arrange child canvases in a fixed-pitch grid (reference layouts.nim)."""

    columns: int
    cell_width: float
    cell_height: float
    padding: float = 8.0
    cells: list[Canvas] = field(default_factory=list)

    def add(self) -> Canvas:
        canvas = Canvas(self.cell_width, self.cell_height)
        self.cells.append(canvas)
        return canvas

    def render(self) -> Canvas:
        rows = -(-len(self.cells) // self.columns) if self.cells else 0
        total = Canvas(
            self.columns * (self.cell_width + self.padding) + self.padding,
            rows * (self.cell_height + self.padding) + self.padding,
            background="white",
        )
        for idx, cell in enumerate(self.cells):
            col, row = idx % self.columns, idx // self.columns
            dx = self.padding + col * (self.cell_width + self.padding)
            dy = self.padding + row * (self.cell_height + self.padding)
            for shape in cell.shapes:
                a = dict(shape.attrs)
                for kx, ky in (("x", "y"), ("x1", "y1"), ("x2", "y2"),
                               ("cx", "cy")):
                    if kx in a:
                        a[kx] = a[kx] + dx
                        a[ky] = a[ky] + dy
                if "points" in a:
                    a["points"] = [(x + dx, y + dy) for x, y in a["points"]]
                total.shapes.append(_Shape(shape.kind, a))
        return total
