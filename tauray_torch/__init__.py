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
  stages/    — path tracer and tonemap
  renderer/  — PathTracerRenderer
  app/       — CLI (`python -m tauray_torch`) and headless output
"""

__version__ = "0.1.0"
