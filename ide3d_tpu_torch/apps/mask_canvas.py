"""Headless 19-class mask editing canvas (the Painter GraphicsScene, sans Qt).

The port's own copy of ide3d_tpu/apps/mask_canvas.py (numpy only). Reference:
Painter/ui/mouse_event.py:33-206 — brush strokes, rectangles, flood fill,
per-class palette, and an undo stack. Any frontend (Qt, web, notebook) can
drive this and feed the result to PainterSession.edit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.seg import COLOR_MAP


class MaskCanvas:
    """Integer class-id canvas with undo/redo (mouse_event.py:61-206)."""

    def __init__(self, size: int = 512, background: int = 0, max_undo: int = 50):
        self.size = size
        self.mask = np.full((size, size), background, np.uint8)
        self._undo: List[np.ndarray] = []
        self._redo: List[np.ndarray] = []
        self._max_undo = max_undo

    # ------------------------------------------------------------------- state

    def _checkpoint(self):
        self._undo.append(self.mask.copy())
        if len(self._undo) > self._max_undo:
            self._undo.pop(0)
        self._redo.clear()

    def undo(self) -> bool:
        if not self._undo:
            return False
        self._redo.append(self.mask.copy())
        self.mask = self._undo.pop()
        return True

    def redo(self) -> bool:
        if not self._redo:
            return False
        self._undo.append(self.mask.copy())
        self.mask = self._redo.pop()
        return True

    def load(self, mask: np.ndarray):
        if mask.shape != self.mask.shape:
            raise ValueError(f"mask shape {mask.shape} != canvas {self.mask.shape}")
        self._checkpoint()
        self.mask = mask.astype(np.uint8).copy()

    # ------------------------------------------------------------------- tools

    def brush(self, points: Sequence[Tuple[int, int]], cls: int, radius: int = 6):
        """Paint a stroke through (x, y) points (mouse_event paint loop)."""
        self._checkpoint()
        yy, xx = np.mgrid[0 : self.size, 0 : self.size]
        stroke = np.zeros_like(self.mask, bool)
        pts = list(points)
        # interpolate between consecutive points for continuous strokes
        dense = []
        for a, b in zip(pts[:-1], pts[1:]):
            n = max(int(np.hypot(b[0] - a[0], b[1] - a[1])), 1)
            for t in np.linspace(0, 1, n + 1):
                dense.append((a[0] + (b[0] - a[0]) * t, a[1] + (b[1] - a[1]) * t))
        if not dense:
            dense = [tuple(map(float, pts[0]))]
        for (x, y) in dense:
            stroke |= (xx - x) ** 2 + (yy - y) ** 2 <= radius**2
        self.mask[stroke] = cls

    def rect(self, x0: int, y0: int, x1: int, y1: int, cls: int):
        self._checkpoint()
        x0, x1 = sorted((max(x0, 0), min(x1, self.size)))
        y0, y1 = sorted((max(y0, 0), min(y1, self.size)))
        self.mask[y0:y1, x0:x1] = cls

    def fill(self, x: int, y: int, cls: int):
        """Flood fill the connected component at (x, y) (mouse_event fill tool)."""
        self._checkpoint()
        target = self.mask[y, x]
        if target == cls:
            return
        # BFS flood fill (vectorized frontier expansion)
        visited = np.zeros_like(self.mask, bool)
        frontier = np.zeros_like(self.mask, bool)
        frontier[y, x] = True
        match = self.mask == target
        while frontier.any():
            visited |= frontier
            grown = np.zeros_like(frontier)
            grown[1:, :] |= frontier[:-1, :]
            grown[:-1, :] |= frontier[1:, :]
            grown[:, 1:] |= frontier[:, :-1]
            grown[:, :-1] |= frontier[:, 1:]
            frontier = grown & match & ~visited
        self.mask[visited] = cls

    # ------------------------------------------------------------------- views

    def to_color(self) -> np.ndarray:
        """[H, W, 3] uint8 palette view (ui/util color map)."""
        return COLOR_MAP.astype(np.uint8)[self.mask]
