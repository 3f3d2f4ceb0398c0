"""Visualization: skeleton overlays and feature-map grids.

(reference: hyperpose/Model/processor.py:8-115 BasicVisualizer/PltDrawer,
Model/openpose/utils.py draw_results). A copy of
`hyperpose_tpu/utils/visualize.py`; matplotlib and OpenCV are imported by
the functions that draw, not with the module.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from .human import Human, draw_humans
from .topology import Topology


class PltDrawer:
    """Grid plotting helper (reference: Model/processor.py PltDrawer)."""

    def __init__(self, draw_row: int, draw_col: int, figsize=(12, 8)):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self.plt = plt
        self.fig, self.axes = plt.subplots(
            draw_row, draw_col, figsize=figsize, squeeze=False
        )
        self._idx = 0
        self.draw_row, self.draw_col = draw_row, draw_col

    def add_subplot(self, image, title: str = "", color_bar: bool = False):
        r, c = divmod(self._idx, self.draw_col)
        ax = self.axes[r][c]
        im = ax.imshow(image)
        ax.set_title(title)
        ax.axis("off")
        if color_bar:
            self.fig.colorbar(im, ax=ax)
        self._idx += 1

    def savefig(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.fig.tight_layout()
        self.fig.savefig(path)
        self.plt.close(self.fig)


class Visualizer:
    """Save prediction/target comparisons and skeleton overlays
    (reference: openpose/utils.py:220+ draw_results; Model/__init__.py
    get_visualizer)."""

    def __init__(self, topology: Topology, save_dir: str = "./save_dir"):
        self.topology = topology
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)

    def visualize_result(
        self, image: np.ndarray, humans: Sequence[Human], name: str
    ) -> str:
        out = draw_humans(image, humans, self.topology)
        path = os.path.join(self.save_dir, f"{name}.png")
        import cv2

        cv2.imwrite(path, cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
        return path

    def visualize_maps(
        self, image: np.ndarray, conf_map: np.ndarray, paf_map: np.ndarray,
        name: str, gt_conf: np.ndarray | None = None,
        gt_paf: np.ndarray | None = None,
    ) -> str:
        """Image + max-reduced conf/paf maps (optionally vs ground truth)."""
        has_gt = gt_conf is not None
        drawer = PltDrawer(2 if has_gt else 1, 3)
        drawer.add_subplot(image.astype(np.uint8), "image")
        drawer.add_subplot(conf_map.max(-1), "conf (max)", color_bar=True)
        drawer.add_subplot(np.abs(paf_map).max(-1), "|paf| (max)", color_bar=True)
        if has_gt:
            drawer.add_subplot(image.astype(np.uint8), "image")
            drawer.add_subplot(gt_conf.max(-1), "gt conf", color_bar=True)
            drawer.add_subplot(np.abs(gt_paf).max(-1), "gt |paf|", color_bar=True)
        path = os.path.join(self.save_dir, f"{name}_maps.png")
        drawer.savefig(path)
        return path
