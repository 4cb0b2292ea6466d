# Copied from tauray_tpu/net/frame_stream.py; FrameServer.close differs.
"""Frame/input streaming (reference: src/frame_server.cc,
src/frame_client.cc).

The reference streams RGB24 frames over NNG bus0 and receives SDL input
events back (reference: frame_server.cc:277-338). NNG isn't available
here, so the same protocol rides a plain TCP socket:

  server -> client:  b"FRME" + u32 w + u32 h + u32 3 + w*h*3 RGB bytes
  client -> server:  b"EVNT" + u32 count + count * {u32 type, i32 a, i32 b}

Event types mirror what the interactive viewer consumes: key down/up
(a = keycode), mouse motion (a = dx, b = dy), quit."""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..log import TR_LOG, TR_WARN

EVENT_QUIT = 0
EVENT_KEY_DOWN = 1
EVENT_KEY_UP = 2
EVENT_MOUSE_MOTION = 3


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class FrameServer:
    """Accepts one viewer client; sends frames, queues received events."""

    def __init__(self, port: int):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind(("0.0.0.0", port))
        self.listener.listen(1)
        self.listener.settimeout(0.1)
        self.client: Optional[socket.socket] = None
        self.events: List[Tuple[int, int, int]] = []
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while self._running:
            if self.client is None:
                try:
                    c, addr = self.listener.accept()
                    TR_LOG(f"frame client connected from {addr}")
                    c.settimeout(0.05)
                    self.client = c
                except socket.timeout:
                    continue
            else:
                try:
                    head = _recv_exact(self.client, 8)
                    if head is None:
                        self.client = None
                        continue
                    magic, count = struct.unpack("<4sI", head)
                    if magic != b"EVNT":
                        continue
                    payload = _recv_exact(self.client, count * 12)
                    with self._lock:
                        for i in range(count):
                            self.events.append(struct.unpack_from(
                                "<Iii", payload, i * 12))
                except socket.timeout:
                    continue
                except OSError:
                    self.client = None

    def send_frame(self, img: np.ndarray) -> bool:
        """img: (H, W, 3|4) float [0,1] or uint8."""
        if self.client is None:
            return False
        if img.dtype != np.uint8:
            img = (np.clip(img[..., :3], 0, 1) * 255 + 0.5).astype(np.uint8)
        h, w = img.shape[:2]
        header = b"FRME" + struct.pack("<III", w, h, 3)
        try:
            self.client.sendall(header + img[..., :3].tobytes())
            return True
        except OSError:
            self.client = None
            return False

    def poll_events(self) -> List[Tuple[int, int, int]]:
        with self._lock:
            ev = self.events
            self.events = []
        return ev

    def close(self):
        # the accept thread wakes within its socket timeouts; it is joined
        # before the sockets it uses are closed (tauray_tpu closes them
        # under it, and the thread then raises on the closed listener)
        self._running = False
        self._thread.join()
        if self.client:
            self.client.close()
        self.listener.close()


class FrameClient:
    """Thin viewer: receives frames, sends input events
    (reference: src/frame_client.cc — needs no scene or renderer)."""

    def __init__(self, connect: str):
        host, _, port = connect.partition(":")
        self.sock = socket.create_connection((host, int(port or 3333)),
                                             timeout=10)

    def recv_frame(self) -> Optional[np.ndarray]:
        head = _recv_exact(self.sock, 16)
        if head is None:
            return None
        magic, w, h, c = struct.unpack("<4sIII", head)
        if magic != b"FRME":
            return None
        data = _recv_exact(self.sock, w * h * c)
        if data is None:
            return None
        return np.frombuffer(data, np.uint8).reshape(h, w, c)

    def send_events(self, events: List[Tuple[int, int, int]]):
        payload = b"EVNT" + struct.pack("<I", len(events))
        for t, a, b in events:
            payload += struct.pack("<Iii", t, a, b)
        self.sock.sendall(payload)

    def close(self):
        self.sock.close()
