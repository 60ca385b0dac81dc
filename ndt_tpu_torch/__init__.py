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
  utils         - drand48, Nelder-Mead, bounding spheres, C-exact kd cells
  native        - the host C++ balls stepper and bounding-sphere fit
  image         - the linear <-> byte pixel model of the output images
  mathnd        - N-D vector math, numpy on the host and torch on the device
  camera        - camera aiming (host) and primary-ray targets (device)
  scene.model   - the Object / Light / Scene builder API
  scene.compile - Scene -> numpy SoA SceneData -> device tables
  scenes        - the workload scenes (balls, anim6d, lights3d)
  render        - cull lists, the CUDA kernels with their plain twins, the
                  fused bounce step and the frame engine (chain and
                  refraction-stack paths)
  kernels       - nvcc build of csrc/*.cu into a ctypes library
"""

__version__ = "0.1.0"

from ndt_tpu_torch.constants import EPSILON

__all__ = ["EPSILON", "__version__"]
