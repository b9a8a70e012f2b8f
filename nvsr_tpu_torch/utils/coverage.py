"""Plane-coverage debug histograms (the port's copy of
nvsr_tpu/utils/coverage.py, which imports no framework).

Re-creates the reference's plane_coverage debug tool
(reference models.py:328-352, APPROX_COV path): accumulate, per plane,
a 2-D histogram of which plane texels the projected sample grids touch,
and dump a log-scale heatmap PNG plus row/column mean-coverage profile
plots. Host-side numpy — this is an offline diagnostic, not hot-path
code (the reference likewise only runs it under its `plane_stats`
debug flag).
"""

from __future__ import annotations

import os

import numpy as np


class PlaneCoverage:
    """Accumulates coverage counts for a set of plane names."""

    def __init__(self, plane_names, logging_res: int = 256):
        self.logging_res = int(logging_res)
        self.counts = {n: np.zeros((self.logging_res, self.logging_res),
                                   dtype=np.int64)
                       for n in plane_names}

    def update(self, plane_name: str, grid) -> None:
        """grid: [N, 2] projected coords in [-1, 1] (the grid_sample
        input). Counts each touched texel once per update (the
        reference's APPROX_COV round+unique, models.py:334-339)."""
        if plane_name not in self.counts:
            return
        res = self.logging_res
        pts = np.asarray(grid).reshape(-1, 2)
        pts = np.round(pts / 2.0 * res + res / 2.0).astype(np.int64)
        pts = np.unique(pts, axis=0)
        pts = np.clip(pts, 0, res - 1)
        self.counts[plane_name][pts[:, 0], pts[:, 1]] += 1

    def save(self, out_dir: str) -> list:
        """Write coverage/plane_coverage_<name>.png (log heatmap) and
        <name>_coverage.png (mean row/col profiles); returns paths."""
        os.makedirs(out_dir, exist_ok=True)
        written = []
        for name, c in self.counts.items():
            img = np.log(c.astype(np.float64) + 1)
            img = (255 * img / max(img.max(), 1e-9)).astype(np.uint8)
            heat_path = os.path.join(out_dir,
                                     f"plane_coverage_{name}.png")
            _write_png(heat_path, img)
            written.append(heat_path)
            prof_path = os.path.join(out_dir, f"{name}_coverage.png")
            _write_profile(prof_path, c.mean(0), c.mean(1))
            written.append(prof_path)
        return written


def _write_png(path: str, gray: np.ndarray) -> None:
    import cv2
    cv2.imwrite(path, gray)


def _write_profile(path: str, rows: np.ndarray, cols: np.ndarray) -> None:
    """Tiny dependency-light line plot (rows/cols mean coverage)."""
    h, w = 200, max(len(rows), 2)
    canvas = np.full((h, w), 255, dtype=np.uint8)
    for series, shade in ((rows, 0), (cols, 120)):
        m = max(float(np.max(series)), 1e-9)
        ys = (h - 1 - (np.asarray(series) / m * (h - 1))).astype(int)
        xs = np.arange(len(series))
        canvas[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)] = shade
    _write_png(path, canvas)
