"""The frame stream (net/frame_stream.py), the interactive loop
(app/interactive.py), the frame client (app/frame_viewer.py) and
--validation of tauray_torch, on the CPU over loopback sockets.

The FRME / EVNT messages are held to tauray_tpu's byte for byte: each
package's server and client write into a raw socket and the bytes are
compared."""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from tauray_torch.net import frame_stream as T
from tauray_tpu.net import frame_stream as J

torch.set_num_threads(2)

CPU = torch.device("cpu")
SPONZA = "proc://sponza?tris=8192"
WAIT = 60.0          # seconds any one wait in these tests may take


def _wait(cond, what):
    end = time.monotonic() + WAIT
    while not cond():
        if time.monotonic() > end:
            raise TimeoutError(what)
        time.sleep(0.01)


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _recv_all(sk, n):
    buf = b""
    sk.settimeout(WAIT)
    while len(buf) < n:
        chunk = sk.recv(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def _server_bytes(mod, img):
    """What mod's FrameServer sends a raw client for one frame."""
    server = mod.FrameServer(0)
    port = server.listener.getsockname()[1]
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=WAIT) \
                as sk:
            _wait(lambda: server.client is not None, "accept")
            assert server.send_frame(img)
            h, w = img.shape[:2]
            return _recv_all(sk, 16 + w * h * 3)
    finally:
        server.close()


def _client_bytes(mod, events):
    """What mod's FrameClient sends a raw server for one event batch."""
    with socket.socket() as ls:
        ls.bind(("127.0.0.1", 0))
        ls.listen(1)
        port = ls.getsockname()[1]
        client = mod.FrameClient(f"127.0.0.1:{port}")
        conn, _ = ls.accept()
        try:
            client.send_events(events)
            return _recv_all(conn, 8 + 12 * len(events))
        finally:
            conn.close()
            client.close()


def test_frame_and_event_bytes_match_jax():
    rng = np.random.default_rng(0)
    events = [(T.EVENT_KEY_DOWN, ord("w"), 0),
              (T.EVENT_MOUSE_MOTION, -7, 3), (T.EVENT_KEY_UP, ord("w"), 0),
              (T.EVENT_QUIT, 0, 0)]
    for img in (rng.random((6, 10, 4), dtype=np.float32) * 1.2 - 0.1,
                rng.integers(0, 256, (5, 3, 3)).astype(np.uint8)):
        got = _server_bytes(T, img)
        assert got[:4] == b"FRME" and len(got) == 16 + img.shape[0] * \
            img.shape[1] * 3
        assert got == _server_bytes(J, img)
    got = _client_bytes(T, events)
    assert got[:4] == b"EVNT"
    assert got == _client_bytes(J, events)


def test_frame_stream_round_trip():
    """Port server -> port client: the frame arrives as RGB bytes, events
    come back in order."""
    server = T.FrameServer(0)
    port = server.listener.getsockname()[1]
    client = T.FrameClient(f"127.0.0.1:{port}")
    try:
        _wait(lambda: server.client is not None, "accept")
        img = np.linspace(0, 1, 4 * 8 * 4, dtype=np.float32).reshape(
            4, 8, 4)
        assert server.send_frame(img)
        frame = client.recv_frame()
        want = (np.clip(img[..., :3], 0, 1) * 255 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(frame, want)
        events = [(T.EVENT_KEY_DOWN, 97, 0), (T.EVENT_MOUSE_MOTION, 4, -2)]
        client.send_events(events)
        got = []
        _wait(lambda: got.extend(server.poll_events()) or len(got) == 2,
              "events")
        assert got == events
    finally:
        client.close()
        server.close()


def _viewer_client(port, frames, errors):
    """A viewer: connects, takes 3 frames, sends a key, a mouse move and
    quit, then reads until the server closes the stream."""
    try:
        end = time.monotonic() + WAIT
        while True:
            try:
                client = T.FrameClient(f"127.0.0.1:{port}")
                break
            except OSError:
                if time.monotonic() > end:
                    raise
                time.sleep(0.05)
        try:
            client.sock.settimeout(WAIT)
            while len(frames) < 3:
                frames.append(client.recv_frame())
            client.send_events([(T.EVENT_KEY_DOWN, ord("w"), 0),
                                (T.EVENT_MOUSE_MOTION, 5, -3),
                                (T.EVENT_KEY_UP, ord("w"), 0),
                                (T.EVENT_QUIT, 0, 0)])
            while True:
                f = client.recv_frame()
                if f is None:
                    break
                frames.append(f)
        finally:
            client.close()
    except Exception as e:  # reported by the test
        errors.append(e)


def test_interactive_loop_scripted():
    """The interactive loop for a few frames on the CPU: stdin commands
    scripted (help, dump, an option that rebuilds the renderer) and a
    viewer sending a key, a mouse move and quit. The loop ends on quit,
    the viewer got at least 3 frames of the right size, not all zero,
    and the camera moved."""
    from tauray_torch.app.interactive import interactive_viewer
    from tauray_torch.app.main import load_scenes
    from tauray_torch.options import parse_command_line_options
    port = _free_port()
    opt = parse_command_line_options([
        "--width=16", "--height=8", "--samples-per-pixel=1",
        "--max-ray-depth=2", f"--port={port}", SPONZA])
    s = load_scenes(opt)
    cam = next(e for e in s.entities
               if e.camera is not None and e.camera_enabled)
    before = np.asarray(cam.transform.get_global_transform()).copy()
    lines = ["help", "dump", "samples-per-pixel 2"]
    frames, errors = [], []
    th = threading.Thread(target=_viewer_client,
                          args=(port, frames, errors), daemon=True)
    th.start()
    interactive_viewer(opt, s, CPU,
                       read_line=lambda: lines.pop(0) if lines else None)
    th.join(WAIT)
    assert not th.is_alive() and not errors, errors
    assert opt.samples_per_pixel == 2
    assert len(frames) >= 3
    for f in frames:
        assert f.shape == (8, 16, 3) and f.dtype == np.uint8 and f.any()
    after = np.asarray(cam.transform.get_global_transform())
    assert np.abs(after - before).max() > 0


def test_frame_client_viewer_writes_frames(tmp_path):
    """--display=frame-client: frames from a server are written through
    the EXR writer (no imaging library); the stream's end ends it."""
    from tauray_torch.app.frame_viewer import frame_client_viewer
    from tauray_torch.io.exr import read_rgb
    from tauray_torch.options import parse_command_line_options
    server = T.FrameServer(0)
    port = server.listener.getsockname()[1]
    prefix = str(tmp_path / "view")
    opt = parse_command_line_options([
        "--display=frame-client", f"--connect=127.0.0.1:{port}",
        f"--headless={prefix}", SPONZA])
    img = np.zeros((4, 6, 3), np.float32)
    img[..., 1] = 1.0

    def serve():
        _wait(lambda: server.client is not None, "accept")
        for _ in range(2):
            server.send_frame(img)
        server.close()
    th = threading.Thread(target=serve, daemon=True)
    th.start()
    assert frame_client_viewer(opt) == 0
    th.join(WAIT)
    assert not th.is_alive()
    got = read_rgb(prefix + ".exr")
    np.testing.assert_array_equal(got[..., :3], img)


def _pt(args, cls=None):
    from tauray_torch.app.main import load_scenes
    from tauray_torch.options import parse_command_line_options
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    opt = parse_command_line_options([
        "--width=16", "--height=8", "--samples-per-pixel=1",
        "--max-ray-depth=2", "--tonemap=linear"] + args + [SPONZA])
    rr = (cls or PathTracerRenderer)(opt, CPU)
    rr.set_scene(load_scenes(opt))
    return rr


def _poison(rr):
    """NaN in every triangle's albedo factor (its tri_packed copy of the
    instance row), which only the shading reads."""
    from tauray_torch.scene.device import IP_ALBEDO, TP_IP
    tp = rr.device_scene.tri_packed.clone()
    tp[:, TP_IP + IP_ALBEDO:TP_IP + IP_ALBEDO + 3] = float("nan")
    rr.device_scene = rr.device_scene._replace(tri_packed=tp)


@pytest.mark.parametrize("distributed", [False, True])
def test_validation_names_the_stage(distributed):
    """--validation: a clean frame passes and equals the frame without
    it; a NaN injected into the shading stage's input raises
    FloatingPointError naming bounce 0's shading. Off, the same frame
    renders without a check."""
    from tauray_torch.renderer.distributed import \
        DistributedPathTracerRenderer
    cls = DistributedPathTracerRenderer if distributed else None
    extra = ["--fake-devices=2"] if distributed else []
    on = _pt(["--validation"] + extra, cls)
    img = on.render()
    np.testing.assert_array_equal(img, _pt(extra, cls).render())
    _poison(on)
    on.reset_accumulation()
    with pytest.raises(FloatingPointError, match="bounce 0 shade"):
        on.render()
    off = _pt(extra, cls)
    _poison(off)
    assert np.isnan(off.render()).any()


def test_validation_camera_and_cli(tmp_path):
    """A NaN in the camera uniforms is named by the camera rays' stage;
    the CLI's replay loop runs a clean --validation frame."""
    from tauray_torch.app.main import load_scenes, replay_viewer
    from tauray_torch.options import parse_command_line_options
    rr = _pt(["--validation"])
    arrays = rr.arrays
    orig = arrays.camera_uniforms

    def nan_camera(vps, prev=None):
        d = orig(vps, prev)
        d["view_inverse"] = d["view_inverse"] * np.nan
        return d
    arrays.camera_uniforms = nan_camera
    with pytest.raises(FloatingPointError, match="camera rays"):
        rr.render()
    opt = parse_command_line_options([
        "--validation", f"--headless={tmp_path / 'v'}", "--width=8",
        "--height=8", "--max-ray-depth=2", "--filetype=none", SPONZA])
    replay_viewer(opt, load_scenes(opt), CPU)
