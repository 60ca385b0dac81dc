"""A cell's control: what its check has to refuse.

``cells/<cell>.json`` names it under ``control``: the program's own lower
precision (``program_dtype``: the cell's traffic in that dtype), or the
reference computed in the next precision down (``reference_dtype``) put
in the program's place, each frame of the window rendered by it from the
plain scene data.  Either way the control runs through ``run_cell`` as a
benchmark run does, so its readings come from the harness's own check of
the window's sampled frames.  The benchmark's runs never run it; the
readings are ``calibrate.py``'s and the ``test_portbench_run`` tests'.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np


@contextlib.contextmanager
def control(cell):
    """The cell to run in place of ``cell`` while the control is on."""
    spec = cell.limits["control"]
    if "program_dtype" in spec:
        yield dataclasses.replace(cell, traffic=dict(
            cell.traffic, dtype=spec["program_dtype"]))
        return
    from ndt_tpu_torch.render import engine

    from portbench import harness, scenegen

    low = spec["reference_dtype"]
    tr = cell.traffic

    def render_frame(data, opts, device):
        img = harness.reference_image(data, cell, device, low)
        return img.astype(np.float32), None, tr["width"] * tr["height"]

    saved = scenegen.to_program_scene, engine.render_frame
    scenegen.to_program_scene = lambda data: data
    engine.render_frame = render_frame
    try:
        yield cell
    finally:
        scenegen.to_program_scene, engine.render_frame = saved
