"""What decides `correct`: the timed path's captured waves held to what
the cell asks of every frame and to the plain reference
(benchmark/reference.py), each number beside its limit.

Numbers:
  * waves_short, rays_short: over the window's frames and the two kinds
    of wave (closest-hit, any-hit), the waves and the rays a frame traced
    short of what the cell's schedule asks. The schedule
    (`rays_per_sample` in the cell's file) is the rays of each kind one
    pixel sample casts in a frame, each in a wave of its own; a frame
    asks that many waves of each kind, and that many times width x height
    x views x samples per pixel rays. Surplus (padding) counts for
    nothing. A frame that skips a bounce, a shadow wave or pixels reads
    above 0. Exact: limit 0.
  * hits_off_ppm: of the sampled rays that could hit (t_max > t_min), the
    share, in parts per million (all of them, 1e6, where none was
    captured), whose answer the reference rules out (off_rays): a
    closest hit too far from every hit or beyond the closest, an any-hit
    verdict or a miss that no hit allows, where a float32 test's
    rounding (MARGIN, carried through the test) is taken both ways.
This module imports nothing of the program."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import reference

# the rounding error a float32 test may make, relative: 16 ulps, carried
# through the test by reference.closest_hits; an answer inside it is
# taken either way
MARGIN = 2.0 ** -20


def _cat(frames: List[List[dict]], key: str):
    return torch.cat([w[key].reshape(len(w["t"]), -1).squeeze(1)
                      for f in frames for w in f])


def sampled_rays(frames: List[List[dict]]) -> Dict[str, torch.Tensor]:
    """Every captured ray of every frame as flat tensors (CPU)."""
    if not any(frames):
        return {}
    out = {k: _cat(frames, k) for k in ("o", "d", "t_min", "t_max", "t",
                                         "hit")}
    out["any_hit"] = torch.cat([torch.full((len(w["t"]),), w["any_hit"])
                                for f in frames for w in f])
    return out


def off_rays(rays: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             t_ans, hit_ans):
    """(live, off) bool masks: the rays that could hit, and those whose
    answer (t_ans, hit_ans) the reference (closest_hits with margin and
    t_ans) rules out. A closest hit has to lie within rounding of a hit
    and not beyond the closest hit that rounding keeps; an any-hit
    verdict has to be one rounding allows; a miss, that no hit rounding
    keeps exists."""
    live = rays["t_max"] > rays["t_min"]
    t_ans = t_ans.double()
    robust, loose, near = ref["robust"], ref["loose"], ref["near"]
    closest_ok = torch.where(hit_ans, (near <= 0) & (t_ans <= robust),
                             torch.isinf(robust))
    any_ok = torch.where(hit_ans, torch.isfinite(loose), torch.isinf(robust))
    ok = torch.where(rays["any_hit"], any_ok, closest_ok)
    return live, live & ~ok


def views(traffic: dict) -> int:
    """The views a frame renders: w x h of the traffic's --camera-grid,
    else one."""
    for o in traffic.get("options", ()):
        if o.startswith("--camera-grid="):
            w, h = o.split("=", 1)[1].split(",")[:2]
            return int(w) * int(h)
    return 1


def schedule(traffic: dict) -> Dict[str, int]:
    """What a cell asks of every frame: the pixel samples (width x height
    x views x samples per pixel) and the rays of each kind a sample casts
    (the cell's `rays_per_sample`)."""
    per = traffic["rays_per_sample"]
    return dict(samples=int(traffic["width"]) * int(traffic["height"]) *
                views(traffic) * int(traffic["samples_per_pixel"]),
                closest=int(per["closest"]), any_hit=int(per["any_hit"]))


def shortfall(frames: List[List[dict]], sched: Dict[str, int]):
    """(waves, rays) the frames traced short of the schedule, summed over
    frames and the two kinds of wave."""
    waves = rays = 0
    for f in frames:
        for kind, any_hit in (("closest", False), ("any_hit", True)):
            ns = [w["n"] for w in f if w["any_hit"] == any_hit]
            waves += max(0, sched[kind] - len(ns))
            rays += max(0, sched[kind] * sched["samples"] - sum(ns))
    return waves, rays


def numbers(frames: List[List[dict]], tris: torch.Tensor,
            sched: Dict[str, int], block: int = 64,
            answer: Optional[str] = None, shown: Optional[list] = None
            ) -> Dict[str, float]:
    """The compared numbers of a run's captured frames against the
    schedule `sched` and the reference over tris (T, 3, 3) (on the device
    the reference runs on). answer="control": the control, TF32, answers
    in the program's place. shown, a list, receives up to 8 of the rays
    found off."""
    waves_short, rays_short = shortfall(frames, sched)
    counts = dict(waves_short=float(waves_short),
                  rays_short=float(rays_short))
    rays = sampled_rays(frames)
    if not rays:
        return dict(counts, hits_off_ppm=1e6, rays_compared=0.0)
    args = (rays["o"], rays["d"], rays["t_min"], rays["t_max"], tris)
    if answer == "control":
        t_ans = reference.control_hits(*args, block=block).cpu()
        hit_ans = torch.isfinite(t_ans)
    else:
        t_ans, hit_ans = rays["t"].double(), rays["hit"]
    ref = {k: v.cpu() for k, v in reference.closest_hits(
        *args, t_ans=torch.where(hit_ans, t_ans, 0.0), margin=MARGIN,
        block=block).items()}
    live, off = off_rays(rays, ref, t_ans, hit_ans)
    if shown is not None:
        for i in torch.nonzero(off).squeeze(1)[:8].tolist():
            shown.append({k: float(v[i]) for k, v in (
                ("any_hit", rays["any_hit"]), ("t_min", rays["t_min"]),
                ("t_max", rays["t_max"]), ("t_ans", t_ans),
                ("t_ref", ref["t"]), ("robust", ref["robust"]),
                ("loose", ref["loose"]), ("near", ref["near"]))})
    n = int(live.sum())
    return dict(counts, hits_off_ppm=1e6 * int(off.sum()) / n if n else 1e6,
                rays_compared=float(n))


def verdict(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit is not correct."""
    checks = {n: {"value": v, "limit": limits.get(n, float("nan"))}
              for n, v in nums.items()}
    return all(v <= limits.get(n, float("nan"))
               for n, v in nums.items()), checks
