"""CLI entry + replay loop for the torch package (reference: src/main.cc,
src/tauray.cc); the counterpart of tauray_tpu.app.main with the same
command-line grammar.

Flow: parse options -> (frame-client: view a remote stream) -> require a
CUDA device -> load scenes -> Looking Glass cameras -> headless replay or
the interactive frame stream. The renderer runs on one explicit
torch.device; with several cards, --fake-devices or --mesh-shape the path
tracer spreads over devices (renderer/distributed.py)."""

from __future__ import annotations

import math
import sys
from typing import List, Optional

import numpy as np
import torch

from .. import options as opt_mod
from ..log import TR_ERR, TR_LOG, TR_WARN, logger
from ..options import Options, parse_command_line_options
from ..scene import animation as anim
from ..scene.camera import Camera, get_camera_jitter_sequence
from ..scene.environment_map import EnvironmentMap
from ..scene.scene import Scene
from ..scene.transformable import Transformable
from ..tracing import TracingRecord
from ..validation import check_nan
from .headless import HeadlessOutput

_FEATURES = ("albedo", "world-normal", "view-normal", "world-pos", "view-pos",
             "distance", "world-motion", "view-motion", "screen-motion",
             "instance-id")

_UP_AXIS_TRANSFORMS = {
    # column-vector matrices (reference: src/tauray.cc:179-196)
    "x": np.array([[0, 0, 1, 0], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                  dtype=np.float32),
    "z": np.array([[0, 1, 0, 0], [0, 0, 1, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
                  dtype=np.float32),
}


def load_scenes(opt: Options) -> Scene:
    from ..io.gltf import load_scene
    s = Scene()
    for path in opt.scene_paths:
        load_scene(path, s)

    if opt.up_axis in _UP_AXIS_TRANSFORMS:
        s.apply_transform(_UP_AXIS_TRANSFORMS[opt.up_axis])

    if opt.envmap:
        e = s.add("envmap")
        e.environment_map = EnvironmentMap(opt.envmap)

    s.ambient = np.asarray(opt.ambient, dtype=np.float32)

    # camera selection (reference: src/tauray.cc:205-250)
    cams = [e for e in s.entities if e.camera is not None]
    enabled = []
    if opt.camera:
        for e in cams:
            if e.name in (opt.camera, opt.camera + "_Orientation"):
                enabled = [e]
                break
        if not enabled:
            raise RuntimeError(f"Failed to find a camera named {opt.camera}.")
    elif cams:
        enabled = [cams[0]]
    else:
        e = s.add("default_camera")
        e.camera = Camera()
        e.camera.perspective(90, opt.width / opt.height, 0.1, 300.0)
        e.transform = Transformable(position=(0, 0, 2))
        enabled = [e]
        TR_WARN("Warning: no camera is defined in the scene, so a default "
                "camera setup is used.")
    for i, e in enumerate(cams if not enabled else s.entities):
        if e.camera is not None:
            e.camera_enabled = e in enabled
    set_camera_params(opt, s)

    if opt.animation_flag:
        anim.play(s, opt.animation, not opt.replay, opt.animation == "")
    return s


def set_camera_params(opt: Options, s: Scene):
    """(reference: src/tauray.cc:69-104 set_camera_params)"""
    for e in s.entities:
        if e.camera is None:
            continue
        c = e.camera
        if opt.force_projection != "off":
            if opt.force_projection == "orthographic":
                c.ortho(-1, 1, -1, 1, c.near, c.far)
            elif opt.force_projection == "equirectangular":
                c.equirectangular(360, 180)
        c.set_aspect(opt.aspect_ratio if opt.aspect_ratio > 0
                     else opt.width / float(opt.height))
        if opt.fov:
            c.set_fov(opt.fov)
        if opt.camera_clip_range.near > 0:
            c.set_near(opt.camera_clip_range.near)
        if opt.camera_clip_range.far > 0:
            c.set_far(opt.camera_clip_range.far)
        dof = opt.depth_of_field
        if dof.f_stop > 0:
            c.set_focus(dof.f_stop, dof.distance, dof.sensor_size,
                        dof.sides, dof.angle)


def create_renderer(opt: Options, s: Scene, device):
    """The renderer for `opt` on `device`. The path tracer spreads over
    devices when the device has more than one card, or --fake-devices or
    --mesh-shape asks for it (tauray_tpu/app/main.py:115-125)."""
    r = opt.renderer
    if r in _FEATURES:
        from ..renderer.feature_renderer import FeatureRenderer
        return FeatureRenderer(opt, device, r)
    if r in ("path-tracer", "direct"):
        from ..parallel.mesh import make_devices
        use_dist = len(make_devices("", device)) > 1 or \
            opt.fake_devices > 1 or bool(opt.mesh_shape)
        if use_dist and not opt.spatial_reprojection:
            from ..renderer.distributed import DistributedPathTracerRenderer
            return DistributedPathTracerRenderer(
                opt, device, direct_only=(r == "direct"))
        from ..renderer.rt_renderer import PathTracerRenderer
        return PathTracerRenderer(opt, device, direct_only=(r == "direct"))
    if r == "whitted":
        from ..renderer.rt_renderer import PathTracerRenderer
        return PathTracerRenderer(opt, device, direct_only=False)
    if r == "raster":
        from ..renderer.raster_renderer import RasterRenderer
        return RasterRenderer(opt, device)
    if r in ("restir", "restir-hybrid"):
        from ..renderer.restir_renderer import ReSTIRRenderer
        return ReSTIRRenderer(opt, device, hybrid=(r == "restir-hybrid"))
    if r in ("dshgi", "dshgi-client"):
        from ..renderer.dshgi_renderer import DSHGIRenderer
        return DSHGIRenderer(opt, device, remote=(r == "dshgi-client"))
    if r == "dshgi-server":
        from ..renderer.dshgi_renderer import DSHGIServer
        return DSHGIServer(opt, device)
    raise ValueError(f"Renderer {r} not implemented yet")


def generate_cameras(s: Scene, opt: Options) -> List:
    """Camera grid generation (reference: src/tauray.cc:680-727)."""
    grid = opt.camera_grid
    base = None
    for e in s.entities:
        if e.camera is not None and e.camera_enabled:
            base = e
            break
    if grid.w * grid.h <= 1:
        return [base]
    views = []
    roll = math.radians(opt.camera_grid_roll)
    cr, sr = math.cos(roll), math.sin(roll)
    total_w = (grid.w - 1) * grid.x
    total_h = (grid.h - 1) * grid.y
    base.camera_enabled = False
    for gy in range(grid.h):
        for gx in range(grid.w):
            x = gx * grid.x - total_w / 2
            y = gy * grid.y - total_h / 2
            lx = x * cr - y * sr
            ly = x * sr + y * cr
            e = s.add(f"grid_cam_{gx}_{gy}")
            cam_copy = __import__(
                "copy").deepcopy(base.camera)
            off = np.asarray(opt.camera_offset, np.float32) + \
                np.array([lx, ly, 0], np.float32)
            t = Transformable(position=off, parent=base.transform)
            # recenter on the zero-disparity plane
            d = opt.camera_recentering_distance
            if math.isfinite(d):
                cam_copy.set_pan(np.array([2 * lx / d, 2 * ly / d],
                                          np.float32) /
                                 cam_copy.get_projection_info()[2:4])
            e.camera = cam_copy
            e.transform = t
            e.camera_enabled = True
            e.camera_index = gy * grid.w + gx
            views.append(e)
    return views


def _finish_frame(img: torch.Tensor, pull: bool):
    """Finish a device frame: full host readback when a file will be
    written, otherwise a one-value readback that waits for the frame."""
    if pull:
        return img.cpu().numpy()
    img.sum().item()
    return img


def replay_viewer(opt: Options, s: Scene, device):
    """Offline/replay render loop (reference: src/tauray.cc:1017-1132).
    A failing frame ends the run. Each view is written to its own file
    (tauray_tpu counts the camera grid only, so its Looking Glass views
    all go to one file name)."""
    generate_cameras(s, opt)
    out = None
    if opt.headless:
        views = sum(e.camera is not None and e.camera_enabled
                    for e in s.entities)
        out = HeadlessOutput(opt, (opt.width, opt.height), views)
        out.skip_nan_check = (opt.renderer in _FEATURES and
                              math.isnan(opt.default_value))

    if opt.taa.sequence_length > 0:
        seq = get_camera_jitter_sequence(
            opt.taa.sequence_length, (opt.width, opt.height))
        for e in s.entities:
            if e.camera is not None:
                e.camera.set_jitter_sequence(seq)

    frame_count = opt.frames if opt.frames else None
    is_animated = anim.is_playing(s)
    if not opt.frames and not is_animated:
        frame_count = 1

    from ..scene.camera import CameraLog
    camera_logs = []
    if opt.camera_log:
        for e in s.entities:
            if e.camera is not None and e.camera_enabled:
                camera_logs.append(CameraLog(e.transform, e.camera))

    from ..progress import ProgressTracker
    progress = ProgressTracker(frame_count or 1,
                               enabled=opt.progress and frame_count)

    rr = create_renderer(opt, s, device)
    rr.set_scene(s)
    if opt.checkpoint and rr.load_checkpoint(opt.checkpoint):
        TR_LOG(f"Resumed accumulation from {opt.checkpoint} "
               f"({rr.samples_accumulated} samples)")
    for _ in range(opt.warmup_frames):
        if not opt.skip_render:
            anim.update(s, 0, True)
            rr.update_frame()
            # renderers whose warm-up only advances internal state (the
            # DSHGI probe blend) have a warmup_step that skips the draw
            if hasattr(rr, "warmup_step"):
                rr.warmup_step()
            else:
                rr.render_device()

    update_dt = round(1000000.0 / opt.framerate)
    i = 0
    tracing = TracingRecord.for_options(opt, device)
    try:
        while frame_count is None or i < frame_count:
            if not opt.frames and is_animated and not anim.is_playing(s):
                break
            dt = 0 if i == 0 else update_dt
            anim.update(s, dt, True)
            for clog in camera_logs:
                clog.frame(dt)
            if not opt.skip_render and i >= opt.skip_frames:
                tracing.begin_frame()
                if i > 0:
                    rr.update_frame()
                rr.reset_accumulation()
                pull = out is not None and out.filetype != "none"
                img = rr.render_device()
                check_nan(opt.validation, "frame", img)
                img = _finish_frame(img, pull)
                tracing.end_frame()
                if out is not None:
                    out.save_frame(img)
            progress.step()
            i += 1
    finally:
        tracing.stop()
    if out is not None:
        out.finish()
    if opt.checkpoint:
        rr.save_checkpoint(opt.checkpoint)
    if opt.camera_log:
        for i, clog in enumerate(camera_logs):
            name = opt.camera_log + (str(i) if len(camera_logs) != 1 else "")
            clog.write(name + ".json")
    tracing.finish()


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    try:
        opt = parse_command_line_options(argv)
    except (KeyError, ValueError) as e:
        TR_ERR(str(e))
        return 1
    if not opt.scene_paths and opt.renderer != "dshgi-server":
        print(opt_mod.help_text())
        return 1
    if getattr(opt, "stereo", 0.0) > 0.0:
        # stereo pair = a 2x1 camera grid at eye distance
        opt.camera_grid.w = 2
        opt.camera_grid.h = 1
        opt.camera_grid.x = opt.stereo
        opt.camera_grid.y = 0.0
    if opt.timing_output:
        logger.timing.stream = open(opt.timing_output, "w")
    # --validation: the renderers check each stage's outputs for NaNs
    # (validation.py), the counterpart of tauray_tpu's jax_debug_nans

    # run-mode selection (reference: src/tauray.cc:1169-1187)
    if opt.display == "frame-client":
        from .frame_viewer import frame_client_viewer
        return frame_client_viewer(opt)
    if not torch.cuda.is_available():
        raise RuntimeError("tauray_torch renders on a CUDA device and none "
                           "is available")
    s = load_scenes(opt)
    if opt.scene_stats:
        TR_LOG("Scene stats:", s.stats())
    setup_display(opt, s)
    run(opt, s, torch.device("cuda"))
    return 0


def setup_display(opt: Options, s: Scene):
    """--display=looking-glass: lkg-params.viewports cameras on an arc
    replace the scene camera (tauray_tpu/app/main.py:340-345)."""
    if opt.display == "looking-glass":
        from ..stages.looking_glass import setup_lkg_cameras
        base = next((e for e in s.entities
                     if e.camera is not None and e.camera_enabled), None)
        if base is not None:
            setup_lkg_cameras(s, base, opt)


def run(opt: Options, s: Scene, device):
    """Headless replay, or the interactive frame stream for a display."""
    if opt.headless or opt.replay or opt.renderer == "dshgi-server":
        replay_viewer(opt, s, device)
    else:
        from .interactive import interactive_viewer
        interactive_viewer(opt, s, device)


if __name__ == "__main__":
    sys.exit(main())
