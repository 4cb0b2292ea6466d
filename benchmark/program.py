"""The benchmark's side of the program under test (tauray_torch): the scene
handed to it as a glTF file, the renderer built from a cell as the command
line builds it, and the recorders the harness puts around the tracer's
entry (every run) and K1's launch (traced runs).

This is the only module of the harness that imports tauray_torch; the
reference (benchmark/reference.py) never does."""

from __future__ import annotations

import tempfile
from typing import Dict, List

import torch

from . import scene as bscene
from .gltf_writer import write_gltf


def options(config: dict, traffic: dict, seed: int, scene_path: str):
    """The port's options for a cell, as a user's command line: the
    configuration's renderer and options, the traffic's size, samples,
    depth and camera grid, the seed as --rng-seed (reduced to 32 bits, the
    width of the port's seed), no file output, and the scene file."""
    from tauray_torch.options import parse_command_line_options
    argv = [f"--renderer={config['renderer']}",
            f"--width={traffic['width']}", f"--height={traffic['height']}",
            f"--max-ray-depth={traffic['max_ray_depth']}",
            f"--samples-per-pixel={traffic['samples_per_pixel']}",
            f"--samples-per-pass={traffic['samples_per_pass']}",
            f"--rng-seed={seed % 2**32}"]
    argv += list(config.get("options", ())) + list(traffic.get("options", ()))
    argv += ["--headless=unused", "--filetype=none", scene_path]
    return parse_command_line_options(argv)


def plain_scene(config: dict) -> bscene.Scene:
    """The configuration's scene as plain records."""
    sc = config["scene"]
    return bscene.sponza(int(sc["tris"]), foliage=bool(sc.get("foliage")))


def load_kernels():
    """Builds (in a checkout's first run) and loads the port's kernel
    libraries, as the first trace would."""
    from tauray_torch.ops.trace_kernel import build_all
    build_all()


def make_renderer(config: dict, traffic: dict, seed: int,
                  plain: bscene.Scene, device: torch.device):
    """The cell's renderer on `device`, built as the command line builds
    it: the scene written as glTF into a directory under TMPDIR, loaded
    by tauray_torch.app.main.load_scenes, the camera grid made by
    generate_cameras, then create_renderer and set_scene. The seed also
    offsets the frame index of renderers whose sample streams follow it
    (ReSTIR's pixel seeds), so that every seed does the same work on other
    samples."""
    from tauray_torch.app.main import (create_renderer, generate_cameras,
                                       load_scenes)
    with tempfile.TemporaryDirectory(prefix="bench_scene_") as tmp:
        opt = options(config, traffic, seed, write_gltf(plain, tmp))
        s = load_scenes(opt)
    generate_cameras(s, opt)
    rr = create_renderer(opt, s, device)
    rr.set_scene(s)
    if hasattr(rr, "frame_idx"):
        rr.frame_idx = seed % 2**20
    return rr


class WaveCapture:
    """Keeps, from every wave handed to the flat tracer's entry
    (ClusterTracer.trace_flagged) while on, the wave's size and whether it
    was any-hit, and `k` rays drawn from the seed with their answers:
    origin, direction, t_min, t_max, the hit's t and whether it hit. The
    draw runs on the device from a generator of its own: nothing is read
    back inside the window. `frames` holds one list of waves per frame
    begun."""

    def __init__(self, k: int, seed: int, device: torch.device):
        self.k = k
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.frames: List[List[dict]] = []
        self.on = False
        self._orig = None

    def begin_frame(self):
        self.frames.append([])

    def record(self, o, d, t_min, t_max, any_hit, hit):
        if not self.on or not self.frames:
            return
        R = o.shape[0]
        idx = torch.randint(0, R, (min(self.k, R),), generator=self.gen,
                            device=o.device)

        def per_ray(x):
            return torch.as_tensor(x, dtype=torch.float32,
                                   device=o.device).expand(R)[idx]
        self.frames[-1].append(dict(
            any_hit=bool(any_hit), n=R, o=o[idx].float(),
            d=d[idx].float(), t_min=per_ray(t_min), t_max=per_ray(t_max),
            t=hit.t[idx].float(), hit=hit.tri_id[idx] >= 0))

    def install(self):
        from tauray_torch.ops.cluster import ClusterTracer
        orig = ClusterTracer.trace_flagged
        cap = self

        def trace_flagged(tracer, origins, dirs, t_min, t_max,
                          any_hit=False, sort_rays=False, need_uv=True):
            hit, flag = orig(tracer, origins, dirs, t_min, t_max,
                             any_hit=any_hit, sort_rays=sort_rays,
                             need_uv=need_uv)
            cap.record(origins, dirs, t_min, t_max, any_hit, hit)
            return hit, flag
        self._orig = orig
        ClusterTracer.trace_flagged = trace_flagged

    def uninstall(self):
        if self._orig is not None:
            from tauray_torch.ops.cluster import ClusterTracer
            ClusterTracer.trace_flagged = self._orig
            self._orig = None

    def to_host(self) -> List[List[dict]]:
        """The captured frames with every tensor moved to the CPU."""
        return [[{k: (v.cpu() if torch.is_tensor(v) else v)
                  for k, v in w.items()} for w in f] for f in self.frames]


class K1Counter:
    """Counts K1's launches through the name ops/cluster.py calls
    (cluster.trace_tiles_vm3, imported there by name), keeping each
    launch's tiles, clusters and the sum of its counts (the cluster visits)
    on the device, read once after the window."""

    def __init__(self):
        self.launches: List[tuple] = []
        self._orig = None

    def install(self):
        from tauray_torch.ops import cluster
        orig = cluster.trace_tiles_vm3
        rec = self

        def trace_tiles_vm3(counts, keys, rays8, tris12):
            rec.launches.append((counts.shape[0], tris12.shape[0],
                                 counts.sum(dtype=torch.int64)))
            return orig(counts, keys, rays8, tris12)
        self._orig = orig
        cluster.trace_tiles_vm3 = trace_tiles_vm3

    def uninstall(self):
        if self._orig is not None:
            from tauray_torch.ops import cluster
            cluster.trace_tiles_vm3 = self._orig
            self._orig = None

    def read(self) -> List[tuple]:
        """[(tiles, clusters, visits)] of every counted launch."""
        return [(int(n), int(c), int(v)) for n, c, v in self.launches]


def traced_counts() -> Dict[str, int]:
    """The tracer's wave and ray counters and each kernel's launches since
    the last reset."""
    from tauray_torch.ops import cluster, trace_kernel
    out = {f"traced_{k}": int(v) for k, v in cluster.TRACED.items()}
    out.update({f"launches_{k}": int(v)
                for k, v in trace_kernel.LAUNCHES.items()})
    return out


def reset_counts():
    from tauray_torch.ops import cluster, trace_kernel
    cluster.reset_traced()
    trace_kernel.reset_launch_counts()


def reset_frame(rr, traffic: dict):
    """Before a frame: the accumulation reset when the traffic asks for
    it (a headless sequence), else the renderer's history kept."""
    if traffic.get("reset_accumulation"):
        rr.reset_accumulation()


def frame_done(img, device: torch.device):
    """Waits for a frame's image on the device."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    else:
        img.sum().item()
