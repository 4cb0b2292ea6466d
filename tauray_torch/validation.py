"""--validation: NaN checks between the stages of a frame, the port's
counterpart of tauray_tpu's `jax_debug_nans` (tauray_tpu/app/main.py:324-330;
the reference's Vulkan validation layers, context.hh:41). Each stage's
outputs are checked as the stage finishes, so the first check to fail
names the stage that produced the NaN. Off, a check is one branch on a
Python bool and reads nothing from the device."""

from __future__ import annotations

import torch


def check_nan(enabled: bool, stage: str, *tensors) -> None:
    """Raise FloatingPointError naming `stage` when one of its floating
    point outputs holds a NaN (one host read per tensor)."""
    if not enabled:
        return
    for x in tensors:
        if isinstance(x, torch.Tensor) and x.is_floating_point() and \
                bool(torch.isnan(x).any()):
            raise FloatingPointError(
                f"--validation: a NaN was first produced by stage {stage!r}")
