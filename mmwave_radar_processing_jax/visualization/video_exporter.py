"""Video export: drive the controller per frame, encode the rendered grid.

Re-design of the reference ``backends/video_exporter.py``: instead of grabbing
Qt widget pixels, a 2x2 grid of matplotlib-backed views subscribes to the
controller's payload stream; each processed frame is rendered to RGB and
appended to an mp4 (libx264, quality 8 — the reference's encode settings).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from mmwave_radar_processing_jax.utils.logger import get_logger
from mmwave_radar_processing_jax.visualization.views import VIEW_CLASSES


class VideoExporter:
    """Renders selected processor views per frame into an mp4."""

    def __init__(self, controller, view_keys: Optional[List[str]] = None,
                 fps: int = 20):
        self.controller = controller
        self.fps = fps
        self.logger = get_logger(__name__)
        self.view_keys = view_keys or self._default_views()

    def _default_views(self) -> List[str]:
        keys = [k for k in self.controller.processors]
        return keys[:4]

    def export(self, out_path: str, start: int = 0,
               end: Optional[int] = None) -> int:
        from mmwave_radar_processing_jax.plotting.movie_generator import (
            _open_writer,
            _open_writer_path,
        )

        out_path = _open_writer_path(out_path, self.logger)
        n_views = len(self.view_keys)
        rows = 1 if n_views <= 2 else 2
        cols = int(np.ceil(n_views / rows))
        fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 4 * rows))
        axes = np.atleast_1d(axes).reshape(-1)

        views: Dict[str, object] = {}
        for ax, key in zip(axes, self.view_keys):
            spec = self.controller.registry[key]
            views[key] = VIEW_CLASSES[spec.view_name](ax=ax)

        def on_update(key, payload):
            if key in views:
                views[key].set_data(payload)

        self.controller.subscribe_view_update(on_update)

        end = end if end is not None else self.controller.dataset_model.num_frames
        writer = _open_writer(out_path, self.fps)
        frames_written = 0
        try:
            for i in range(start, end):
                self.controller.process_next_frame(i)
                fig.canvas.draw()
                buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
                writer.append_data(buf)
                frames_written += 1
        finally:
            writer.close()
            plt.close(fig)
        self.logger.info("exported %d frames to %s", frames_written, out_path)
        return frames_written
