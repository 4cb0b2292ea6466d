# Copied from tauray_tpu/parallel/load_balancer.py.
"""Dynamic load balancer (reference: src/load_balancer.cc:12-32).

Re-weights per-device workload fractions from measured per-device render
times with an EMA (alpha = 0.1), exactly as the reference."""

from __future__ import annotations

from typing import List, Optional, Sequence


class LoadBalancer:
    def __init__(self, device_count: int,
                 initial_weights: Optional[Sequence[float]] = None):
        w = list(initial_weights or [])
        w = w[:device_count] + [0.0] * (device_count - len(w))
        s = sum(w)
        add = 0.0
        if s == 0:
            add = 1.0
            s = float(device_count)
        self.workloads: List[float] = [(max(x, 0.0) + add) / s for x in w]

    def update(self, renderer, times: Optional[Sequence[float]] = None):
        """times: measured per-device 'path tracing' seconds; if None they
        are queried from the renderer's timing record."""
        if times is None:
            timing = renderer.get_timing()
            times = [timing.get((i, "path tracing"), 0.0)
                     for i in range(len(self.workloads))]
        speeds = []
        for w, t in zip(self.workloads, times):
            speeds.append(max(w / t, 0.0) if t > 0 else 0.0)
        total = sum(speeds)
        if total > 0 and all(s == s for s in speeds):  # finite
            self.workloads = [
                w * 0.9 + (s / total) * 0.1
                for w, s in zip(self.workloads, speeds)]
        renderer.set_device_workloads(self.workloads)
        return self.workloads
