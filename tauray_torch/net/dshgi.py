"""DSHGI probe streaming (reference: src/dshgi_server.cc:171-280,
src/dshgi_client.cc); the torch counterpart of tauray_tpu.net.dshgi.

The message schema mirrors the reference's ZMQ stream: a `timestamp`, a
`sh_grid_count`, then one message per grid carrying {index, order, radius,
transform, resolution, payload}; the payload is the raw float32 SH
coefficient grid. The transport is ZeroMQ PUB/SUB; the server counts its
subscribers and publishes nothing while nobody listens (reference:
dshgi_server.cc:144-167). `zmq` is imported only where a socket is made.
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..log import TR_WARN

RATE_LIMIT_BITS_PER_S = 1_000_000_000  # 1 Gbps (dshgi_server.cc:175)


def _grid_message(index: int, order: int, radius: float,
                  transform: np.ndarray, coef: np.ndarray) -> bytes:
    """One grid's message: b"sh_grid", the header length, the header
    (index, order, 0, radius, rx, ry, rz), the 4x4 transform and the
    coefficients (rz, ry, rx, C, channels), all little-endian float32 /
    int32, byte for byte as tauray_tpu writes them."""
    rz, ry, rx = coef.shape[:3]
    header = struct.pack(
        "<iiifiii", index, order, 0, radius, rx, ry, rz)
    return (b"sh_grid" + struct.pack("<i", len(header)) + header +
            transform.astype(np.float32).tobytes() +
            coef.astype(np.float32).tobytes())


def _parse_grid_message(data: bytes):
    """(index, order, radius, transform (4, 4), coef (rz, ry, rx, C, K)).
    The channel count K (3 for RGB, 4 with the probes' visibility
    distance, as the bake writes) is what the payload's length holds; the
    header does not carry it."""
    assert data[:7] == b"sh_grid"
    (hlen,) = struct.unpack_from("<i", data, 7)
    off = 11
    index, order, _, radius, rx, ry, rz = struct.unpack_from("<iiifiii",
                                                             data, off)
    off += hlen
    transform = np.frombuffer(data, np.float32, 16, off).reshape(4, 4)
    off += 64
    C = (order + 1) ** 2
    n = rz * ry * rx * C
    K = (len(data) - off) // (4 * n)
    if K * 4 * n != len(data) - off:
        raise ValueError(f"sh_grid payload of {len(data) - off} bytes is "
                         f"not a whole grid of {n} coefficients")
    coef = np.frombuffer(data, np.float32, n * K, off).reshape(
        rz, ry, rx, C, K)
    return index, order, radius, transform, coef


class DSHGIServerTransport:
    """ZMQ publisher side."""

    def __init__(self, port: int):
        import zmq
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.XPUB)
        self.sock.bind(f"tcp://*:{port}")
        self.subscribers = 0
        self._budget = RATE_LIMIT_BITS_PER_S / 8.0
        self._last = time.monotonic()

    def poll_subscribers(self):
        while self.sock.poll(0):
            msg = self.sock.recv()
            if msg and msg[0] == 1:
                self.subscribers += 1
            elif msg and msg[0] == 0:
                self.subscribers = max(self.subscribers - 1, 0)

    def publish(self, grids: List[Tuple]) -> bool:
        """grids: a list of (coef, world_to_local) tensors or arrays.
        False when nobody listens or the rate budget is spent."""
        self.poll_subscribers()
        if self.subscribers == 0:
            return False
        now = time.monotonic()
        self._budget = min(self._budget + (now - self._last) *
                           RATE_LIMIT_BITS_PER_S / 8.0,
                           RATE_LIMIT_BITS_PER_S / 8.0)
        self._last = now
        msgs = [b"timestamp" + struct.pack("<q", time.time_ns() // 1000),
                b"sh_grid_count" + struct.pack("<i", len(grids))]
        for i, (coef, w2l) in enumerate(grids):
            coef = _host(coef)
            order = int(np.sqrt(coef.shape[3])) - 1
            msgs.append(_grid_message(i, order, 0.0, _host(w2l), coef))
        total = sum(len(m) for m in msgs)
        if total > self._budget:
            return False  # rate limited this frame
        self._budget -= total
        for m in msgs:
            self.sock.send(m)
        return True

    def close(self):
        self.sock.close(0)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class DSHGIClient:
    """Receiver thread and the `sh_source` interface of RasterRenderer
    (reference: src/dshgi_client.hh:37-71); grids come out as tensors on
    `device`."""

    def __init__(self, connect: str, device):
        import zmq
        if "://" not in connect:
            connect = f"tcp://{connect}"
        self.device = torch.device(device)
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.SUB)
        self.sock.connect(connect)
        self.sock.setsockopt(zmq.SUBSCRIBE, b"")
        self._lock = threading.Lock()
        self._grids: Dict[int, Tuple] = {}
        self._running = True
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()

    def _recv_loop(self):
        while self._running:
            if not self.sock.poll(100):
                continue
            data = self.sock.recv()
            if data.startswith(b"sh_grid") and not \
                    data.startswith(b"sh_grid_count"):
                try:
                    index, order, radius, transform, coef = \
                        _parse_grid_message(data)
                    with self._lock:
                        self._grids[index] = (coef.copy(), transform.copy())
                except Exception as e:  # tolerate malformed packets
                    TR_WARN(f"dshgi client: bad grid message: {e}")

    # sh_source interface ------------------------------------------------
    def step(self, host_renderer):
        pass  # grids arrive asynchronously

    def current_grid_data(self) -> Optional[Tuple]:
        with self._lock:
            if 0 not in self._grids:
                return None
            coef, w2l = self._grids[0]
        return (torch.from_numpy(coef).to(self.device),
                torch.from_numpy(w2l).to(self.device))

    def close(self):
        self._running = False
        self._thread.join(timeout=1)
        self.sock.close(0)
