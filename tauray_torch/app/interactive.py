"""Interactive run loop (reference: src/tauray.cc:767-1015
interactive_viewer); the torch counterpart of tauray_tpu.app.interactive
with the renderer on the port's device.

Frames stream to a remote viewer through the frame server (reference
frame_server display type), which sends back the same inputs: WASD+mouse
FPS camera, live stdin commands (`help`, `dump`, `quit`, `<option>
<value>`) that re-configure and rebuild the renderer (reference:
src/tauray.cc:833-863), accumulation reset on camera movement (reference:
src/tauray.cc:971-979), and a frame throttle (reference:
src/tauray.cc:37-66)."""

from __future__ import annotations

import select
import sys
import time

import numpy as np

from ..log import TR_ERR, TR_LOG
from ..net.frame_stream import (EVENT_KEY_DOWN, EVENT_KEY_UP,
                                EVENT_MOUSE_MOTION, EVENT_QUIT, FrameServer)
from ..options import parse_live_command
from ..scene import animation as anim
from ..tracing import TracingRecord

_KEY_DIRS = {  # ascii keycodes -> camera-local movement
    ord("w"): (0, 0, -1), ord("s"): (0, 0, 1),
    ord("a"): (-1, 0, 0), ord("d"): (1, 0, 0),
    ord("q"): (0, -1, 0), ord("e"): (0, 1, 0),
}


def _nonblock_getline():
    """(reference: src/misc.cc nonblock_getline)"""
    r, _, _ = select.select([sys.stdin], [], [], 0)
    if r:
        return sys.stdin.readline().strip()
    return None


def interactive_viewer(opt, s, device, read_line=_nonblock_getline):
    """Render and stream frames until the viewer sends quit or a `quit`
    command arrives. read_line returns the next stdin command, or None
    when there is none (tests script it)."""
    from .main import create_renderer, set_camera_params

    server = FrameServer(opt.port)
    TR_LOG(f"interactive: streaming frames on port {opt.port}; "
           "type option commands on stdin ('help', 'dump', 'quit')")

    rr = create_renderer(opt, s, device)
    rr.set_scene(s)
    tracing = TracingRecord.for_options(opt, device)

    cam_e = next(e for e in s.entities
                 if e.camera is not None and e.camera_enabled)
    cam_t = cam_e.transform
    pitch, yaw = 0.0, 0.0
    pressed = set()
    running = True
    last = time.perf_counter()
    sensitivity = 0.2

    try:
        while running:
            now = time.perf_counter()
            dt = now - last
            last = now
            if opt.throttle > 0:
                min_dt = 1.0 / opt.throttle
                if dt < min_dt:
                    time.sleep(min_dt - dt)

            camera_moved = False
            line = read_line()
            if line is not None:
                result = parse_live_command(opt, line)
                if result == "quit":
                    break
                if result:
                    print(result)
                else:
                    # option changed: rebuild the renderer
                    # (reference: src/tauray.cc recreate_renderer)
                    try:
                        set_camera_params(opt, s)
                        rr = create_renderer(opt, s, device)
                        rr.set_scene(s)
                        camera_moved = True
                    except Exception as e:  # keep the session alive
                        TR_ERR(f"renderer rebuild failed: {e}")

            for (etype, a, b) in server.poll_events():
                if etype == EVENT_QUIT:
                    running = False
                elif etype == EVENT_KEY_DOWN:
                    pressed.add(a)
                elif etype == EVENT_KEY_UP:
                    pressed.discard(a)
                elif etype == EVENT_MOUSE_MOTION:
                    yaw -= a * sensitivity
                    pitch = max(-90.0, min(90.0, pitch - b * sensitivity))
                    cam_t.set_orientation(pitch, yaw)
                    camera_moved = True

            move = np.zeros(3, np.float32)
            for key in pressed:
                if key in _KEY_DIRS:
                    move += np.asarray(_KEY_DIRS[key], np.float32)
            if np.any(move != 0):
                rot = cam_t.get_global_transform()[:3, :3]
                cam_t.translate(rot @ (move * dt * 2.0))
                camera_moved = True

            anim.update(s, round(dt * 1e6), False)
            if camera_moved:
                rr.reset_accumulation()
            rr.update_frame()
            tracing.begin_frame()
            img = rr.render()
            tracing.end_frame()
            server.send_frame(img[0])
    finally:
        tracing.stop()
        server.close()
    tracing.finish()
