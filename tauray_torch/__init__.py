"""tauray_torch — the PyTorch/CUDA port of tauray_tpu.

It mirrors tauray_tpu's module layout and names and is held to it by the
tests: the JAX package is the reference. The port renders on one explicit
torch.device; its traversal runs in a CUDA kernel written for Hopper
(csrc/trace_tiles.cu), and every other device stage is plain torch.

Layout:
  io/        — EXR and glTF/procedural scene loading (copied, numpy)
  scene/     — scene graph, SceneArrays (numpy), DeviceScene (torch)
  ops/       — RNG, sampling, BSDF, lights, shading, cluster tracer, kernel
  csrc/      — CUDA C++ kernel sources, built with nvcc on first use
  native/    — host C++ (EXR PIZ Huffman decode, Morton order), built
               with g++ on first use
  stages/    — path tracer, ReSTIR, raster, shadow maps, post, tonemap,
               Looking Glass composition
  renderer/  — the path-tracing, distributed, feature, ReSTIR, raster and
               DSHGI renderers
  parallel/  — devices, distribution strategies, stitch, load balancer
  net/       — DSHGI probe streaming, the frame/input stream
  app/       — CLI (`python -m tauray_torch`), headless output, the
               interactive loop and frame client, bench
  lab/       — the K1 labs: the TPU lab scripts' kernels that take K1
               apart (csrc/k1_lab.cu), with their entry points
"""

import os
from typing import Optional

__version__ = "0.1.0"


def reference_data(name: str) -> Optional[str]:
    """Path of `name` in the data directory of the reference checkout
    named by TAURAY_REFERENCE_DIR (its data assets: the BRDF LUT, the PCF
    noise texture), or None when the variable is not set."""
    root = os.environ.get("TAURAY_REFERENCE_DIR")
    return os.path.join(root, "data", name) if root else None
