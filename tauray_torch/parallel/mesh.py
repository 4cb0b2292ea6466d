"""The render devices (the counterpart of tauray_tpu.parallel.mesh.make_mesh
and of the reference's `--devices` / `--fake-devices` device selection,
reference: src/context.cc device filtering)."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


def make_devices(shape: str, device) -> List[torch.device]:
    """The devices a multi-device renderer spreads over. A CUDA `device`
    gives cuda:0 .. cuda:n-1 of torch.cuda.device_count(), cut to the
    product of `shape` (the --mesh-shape option: '' uses every card, 'N'
    the first N, '4,2' the first 8); a CPU `device` gives [cpu]. Asking
    for more devices than exist takes the ones that exist, as make_mesh
    does."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    devs = [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]
    if shape:
        dims = [int(x) for x in shape.split(",") if x]
        devs = devs[:int(np.prod(dims))]
    return devs


def to_device(obj, device: torch.device):
    """A copy of a tensor, NamedTuple (DeviceScene, CameraUniforms) or
    dataclass (the tracers) with every tensor on `device`; tensors already
    there are shared, not copied."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_replace"):
        return obj._replace(**{k: to_device(v, device)
                               for k, v in obj._asdict().items()})
    return obj
