"""The 'yaml' scene (scenes/yaml.c): renders the scenes of a YAML file
named by the -u config string, one document per frame.  Needs PyYAML."""

from __future__ import annotations

from ndt_tpu_torch.scene.model import Scene
from ndt_tpu_torch.scene.yaml_io import (scene_read_yaml,
                                         scene_yaml_count_frames)


def scene_frames(dimensions, config=None):
    if not config:
        return 0
    return scene_yaml_count_frames(config)


def scene_setup(scn: Scene, dimensions, frame, frames, config=None):
    if not config:
        raise ValueError("yaml scene requires -u <file.yaml>")
    n = scene_yaml_count_frames(config)
    loaded = scene_read_yaml(config, min(frame, n - 1))
    scn.name = loaded.name
    scn.dim = loaded.dim
    scn.objects = loaded.objects
    scn.lights = loaded.lights
    scn.ambient = loaded.ambient
    scn.bg = loaded.bg
    scn.bg_alpha = loaded.bg_alpha
    scn.cam = loaded.cam
    return 1
