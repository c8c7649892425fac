"""Live trajectory canvas — the reference's drawPaths/imshow equivalent
(a copy of vo_tpu/utils/live.py).

The reference redraws gt (green) and estimated (red) paths on an 800x800
canvas every frame (`drawPaths`, feature_tracking.cpp:312-328, imshow +
waitKey(1)). Headless plot generation stays the default here; this opt-in
view exists for interactive parity (`vo_tpu_torch.runtime.cli --live`).
It degrades to a no-op when cv2 or a display is unavailable, so scripted
runs never crash on it.

Latency note: the pipelines dispatch asynchronously; the CLI feeds this
view only with poses that have already ARRIVED on the host (`run_vo`'s
`on_frame`, never blocking the dispatch loop), so the canvas lags the
device by a few frames — the analogue of the reference paying an imshow
stall every frame, without the stall.
"""

from __future__ import annotations

import numpy as np


class LiveTrajectoryView:
    def __init__(self, size: int = 800, scale: float = 1.0,
                 title: str = "vo_tpu_torch trajectory"):
        self.size = size
        self.scale = scale
        self.title = title
        self._gt: list = []
        self._est: list = []
        try:
            import cv2

            self._cv2 = cv2
            self._canvas = np.zeros((size, size, 3), np.uint8)
            # probe for a usable GUI once; fall back to no-op headless
            cv2.imshow(title, self._canvas)
            cv2.waitKey(1)
            self._ok = True
        except Exception:
            self._ok = False

    def update(self, gt_xy, est_xy) -> None:
        """Append one (x, z) pair of points and redraw (reference draw
        semantics: offset into the canvas center-bottom, green gt / red
        est, cv::circle radius 1)."""
        self._gt.append(np.asarray(gt_xy, np.float64))
        self._est.append(np.asarray(est_xy, np.float64))
        if not self._ok:
            return
        cv2 = self._cv2
        c = self._canvas

        def pt(p):
            x = int(round(p[0] * self.scale)) + self.size // 2
            y = self.size - 100 - int(round(p[1] * self.scale))
            return x, y

        cv2.circle(c, pt(self._gt[-1]), 1, (0, 255, 0), 2)
        cv2.circle(c, pt(self._est[-1]), 1, (0, 0, 255), 2)
        cv2.imshow(self.title, c)
        cv2.waitKey(1)

    def close(self) -> None:
        if self._ok:
            try:
                self._cv2.destroyWindow(self.title)
            except Exception:
                pass
