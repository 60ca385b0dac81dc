"""ndt_tpu_torch — the hyper-dimensional ray tracer on PyTorch and CUDA.

A port of ``ndt_tpu`` (JAX + Pallas) to PyTorch with hand-written CUDA C++
kernels for one NVIDIA Hopper card.  The JAX package stays the reference
each module here is held against; module names and call structure follow
it, so ``ndt_tpu_torch.render.engine.render_frame`` is the counterpart of
``ndt_tpu.render.engine.render_frame``.

This package imports torch and never jax, flax or any module of
``ndt_tpu``: it keeps its own copies of the host helpers it needs.

Layer map:
  constants     - EPSILON, BIG and the other numeric conventions
  utils         - drand48, Nelder-Mead, bounding spheres, the kd-tree
  native        - the host C++ balls stepper and bounding-sphere fit
  image_io      - the pixel model, PNG encode / decode, depth maps, the
                  background saver
  mathnd        - N-D vector math, numpy on the host and torch on the device
  camera        - camera aiming (host) and primary-ray targets (device)
  scene.model   - the Object / Light / Scene builder API
  scene.compile - Scene -> numpy SoA SceneData -> device tables
  scene.yaml_io - YAML scene files (PyYAML at first use)
  scenes        - the workload scenes of the reference's registry
  render        - cull lists, the CUDA kernels with their plain twins, the
                  fused bounce step, the frame engine (chain and
                  refraction-stack paths, cameras, stereo layouts),
                  Whitted and adaptive refinement, the animation loop
  kernels       - nvcc build of csrc/*.cu into a ctypes library
  parallel      - frames split over several devices, the frame modes'
                  process group (torch.distributed over gloo)
  cli           - the `ndt` command line (python -m ndt_tpu_torch.cli)
"""

__version__ = "0.1.0"

from ndt_tpu_torch.constants import EPSILON

__all__ = ["EPSILON", "__version__"]
