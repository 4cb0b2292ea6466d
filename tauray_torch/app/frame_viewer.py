"""Frame client run mode (reference: src/frame_client.cc — a thin viewer
that needs no scene or renderer); the torch counterpart of
tauray_tpu.app.frame_viewer. Without a display, received frames are
written to a rolling file through the port's EXR writer (zip), which
needs no imaging library; tauray_tpu writes PNG through Pillow."""

from __future__ import annotations

import time

import numpy as np

from ..io import exr
from ..log import TR_LOG
from ..net.frame_stream import FrameClient


def frame_client_viewer(opt) -> int:
    client = FrameClient(opt.connect)
    TR_LOG(f"frame client connected to {opt.connect}")
    prefix = opt.headless or "frame_client_view"
    count = 0
    t0 = time.perf_counter()
    try:
        while True:
            frame = client.recv_frame()
            if frame is None:
                TR_LOG("stream ended")
                break
            count += 1
            if count % 30 == 1:
                exr.write_rgb(f"{prefix}.exr",
                              frame.astype(np.float32) / 255.0,
                              compression="zip")
                fps = count / (time.perf_counter() - t0)
                TR_LOG(f"{count} frames ({fps:.1f} fps), "
                       f"latest saved to {prefix}.exr")
    except KeyboardInterrupt:
        pass
    finally:
        client.close()
    return 0
