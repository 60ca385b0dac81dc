"""The workload scenes, with the reference's plugin ABI (README.md:60-135):

    scene_setup(scn, dimensions, frame, frames, config) -> None | int
    scene_frames(dimensions, config) -> int           (optional)
    scene_cleanup() -> None                           (optional)

where ``scn`` is an ``ndt_tpu_torch.scene.Scene``: every scene of the JAX
package's registry.  get_scene also loads a Python scene file by path.
"""

from __future__ import annotations

import importlib
import importlib.util
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
    "yaml": "ndt_tpu_torch.scenes.yaml_scene",
}


def scene_names():
    return sorted(_SCENES)


def get_scene(name: str):
    """Resolve a scene module by name ('balls', 'scenes/balls.so',
    'balls.py') or load a Python scene file by its path."""
    base = os.path.basename(name)
    for suffix in (".so", ".py", ".c"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    if base in _SCENES:
        return importlib.import_module(_SCENES[base])
    if os.path.exists(name) and name.endswith(".py"):
        spec = importlib.util.spec_from_file_location(base, name)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    raise ValueError(f"unknown scene {name!r}; available: {scene_names()}")
