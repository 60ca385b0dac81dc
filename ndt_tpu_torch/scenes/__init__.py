"""The workload scenes, with the reference's plugin ABI (README.md:60-135):

    scene_setup(scn, dimensions, frame, frames, config) -> None | int
    scene_frames(dimensions, config) -> int           (optional)
    scene_cleanup() -> None                           (optional)

where ``scn`` is an ``ndt_tpu_torch.scene.Scene``.  Every scene of the JAX
package's registry but ``yaml`` (the YAML reader is not ported yet).
"""

from __future__ import annotations

import importlib
import os

_SCENES = {
    "test": "ndt_tpu_torch.scenes.builtin",
    "builtin": "ndt_tpu_torch.scenes.builtin",
    "empty": "ndt_tpu_torch.scenes.empty",
    "balls": "ndt_tpu_torch.scenes.balls",
    "hypercube": "ndt_tpu_torch.scenes.hypercube",
    "hypercube-points": "ndt_tpu_torch.scenes.hypercube_points",
    "random": "ndt_tpu_torch.scenes.random_scene",
    "cluster5d": "ndt_tpu_torch.scenes.cluster5d",
    "lights3d": "ndt_tpu_torch.scenes.lights3d",
    "infinite4d": "ndt_tpu_torch.scenes.infinite4d",
    "anim6d": "ndt_tpu_torch.scenes.anim6d",
    "nelder-mead": "ndt_tpu_torch.scenes.nelder_mead_scene",
}


def scene_names():
    return sorted(_SCENES)


def get_scene(name: str):
    """Resolve a scene module by name ('balls', 'scenes/balls.so',
    'balls.py')."""
    base = os.path.basename(name)
    for suffix in (".so", ".py", ".c"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    if base in _SCENES:
        return importlib.import_module(_SCENES[base])
    raise ValueError(f"unknown scene {name!r}; available: {scene_names()}")
