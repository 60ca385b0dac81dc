"""The port's multi-process runs on the CPU: two real processes join a
gloo process group (``ndt_tpu_torch.parallel.distributed``) and render
through the pixel split and the frame modes; each must reproduce the
single-process result to the bit.  The children import neither jax nor
the JAX package (tests/test_distributed.py is the JAX package's
counterpart)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from _torch_common import ensure_port_native, port_scene, reset_port_scenes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COORD_SCENE = os.path.join(REPO, "tests", "_torch_coord_scene.py")
CHILD_TIMEOUT_S = 240

_PRELUDE = """
import json, os, sys
port, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
import numpy as np
import torch
torch.set_num_threads(2)
"""

_CHILD_SPLIT = _PRELUDE + """
from ndt_tpu_torch.parallel.distributed import (broadcast_scene,
                                                 init_distributed,
                                                 is_coordinator)
from ndt_tpu_torch.render.engine import RenderOptions, render_frame
from ndt_tpu_torch.scene import Scene
from ndt_tpu_torch.scene.yaml_io import scene_to_dict
from ndt_tpu_torch.scenes import get_scene

rank, count = init_distributed(f"localhost:{port}", 2, pid)
assert (rank, count) == (pid, 2), (rank, count)

def scene(name, dim, frame, frames):
    mod = get_scene(name)
    scn = Scene(name, dim)
    mod.scene_setup(scn, dim, frame, frames)
    if hasattr(mod, "scene_cleanup"):
        mod.scene_cleanup()
    return scn

# -b r over both processes: each has one CPU place of two
img, depth, rays = render_frame(
    scene("balls", 4, 0, 1500),
    RenderOptions(width=128, height=96, record_depth=True, devices=("cpu",)),
    device="cpu")
np.save(os.path.join(outdir, f"color_{pid}.npy"), img)
np.save(os.path.join(outdir, f"depth_{pid}.npy"), depth)
docs = [scene_to_dict(broadcast_scene(scene(*args) if is_coordinator()
                                      else None))
        for args in (("balls", 4, 0, 1500), ("anim6d", 6, 1, 4))]
with open(os.path.join(outdir, f"out_{pid}.json"), "w") as f:
    json.dump({"rays": rays, "docs": docs}, f)
bad = [m for m in sys.modules if m in ("jax", "ndt_tpu")
       or m.startswith(("jax.", "ndt_tpu."))]
assert not bad, bad
print(f"child {pid} ok", flush=True)
"""

_CHILD_FRAMES = _PRELUDE + """
from ndt_tpu_torch import cli

scene_path, mode = sys.argv[4], sys.argv[5]
os.chdir(outdir)
assert cli.main(["-s", scene_path, "-d", "3", "-f", "0:1", "-r", "32x24",
                 "-b", mode, "--coordinator", f"localhost:{port}",
                 "--num-processes", "2", "--process-id", str(pid)],
                device="cpu") == 0
print(f"child {pid} ok", flush=True)
"""


def run_children(tmp_path, code, *extra):
    """Run ``code`` as two processes of a gloo group on a free localhost
    port; each must exit 0 within CHILD_TIMEOUT_S."""
    ensure_port_native()               # built before the children load it
    child = tmp_path / "child.py"
    child.write_text(code)
    out = tmp_path / f"out{'_'.join(('',) + extra[1:])}"
    out.mkdir()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, str(child), str(port), str(i), str(out), *extra],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"child {i} failed:\n{text[-3000:]}"
    return out


@pytest.fixture(autouse=True)
def _reset_port_scenes():
    yield
    reset_port_scenes()


def normal(doc):
    return json.loads(json.dumps(doc))


def test_two_process_split_and_scene_broadcast(tmp_path):
    """-b r over two processes (balls 4-D f0 128x96, three 4096-ray tiles:
    two on process 0, one on process 1): both processes' gathered frames,
    depth maps and ray counts equal the single-process frame's, bit for
    bit.  broadcast_scene ships the coordinator's balls and anim6d scenes:
    what every process rebuilds equals the YAML round trip
    (scene_write_yaml_buffer, scene_read_yaml_buffer) of the same
    scenes."""
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scene.yaml_io import (scene_read_yaml_buffer,
                                             scene_to_dict,
                                             scene_write_yaml_buffer)
    from ndt_tpu_torch.scenes import get_scene

    out = run_children(tmp_path, _CHILD_SPLIT)
    reset_port_scenes()
    img, depth, rays = render_frame(
        port_scene("balls", 4, 0, 1500),
        RenderOptions(width=128, height=96, record_depth=True), device="cpu")
    docs = []
    for name, dim, frame, frames in (("balls", 4, 0, 1500),
                                     ("anim6d", 6, 1, 4)):
        reset_port_scenes()
        scn = Scene(name, dim)             # as scene_setup leaves it
        get_scene(name).scene_setup(scn, dim, frame, frames)
        docs.append(normal(scene_to_dict(scene_read_yaml_buffer(
            scene_write_yaml_buffer(scn)))))
    for pid in range(2):
        np.testing.assert_array_equal(np.load(out / f"color_{pid}.npy"), img)
        np.testing.assert_array_equal(np.load(out / f"depth_{pid}.npy"),
                                      depth)
        got = json.loads((out / f"out_{pid}.json").read_text())
        assert got["rays"] == rays
        assert got["docs"] == docs


def test_coordinator_built_frame_mode(tmp_path):
    """-b f over two processes through the command line: only process 0
    runs scene_setup (the scene is rank-dependent: red on process 0,
    green elsewhere) and process 1 renders both frames, each equal to the
    serial run's PNG bytes -- the scene rode the broadcast.  With -b F
    every process replays scene_setup and renders its stride: frame 0
    (process 0) equals the serial frame, frame 1 (process 1's green
    sphere) does not."""
    from ndt_tpu_torch.render.animate import render_animation
    from ndt_tpu_torch.render.engine import RenderOptions
    from ndt_tpu_torch.scenes import get_scene

    frames = {mode: run_children(tmp_path, _CHILD_FRAMES, COORD_SCENE, mode)
              for mode in ("f", "F")}
    ref = tmp_path / "ref"
    render_animation(get_scene(COORD_SCENE), 3, 0, 1, 2,
                     RenderOptions(width=32, height=24), str(ref),
                     device="cpu")
    sub = os.path.join("images", "coord", "3d", "32x24")
    for i in range(2):
        want = (ref / f"coord_32x24_{i:04d}.png").read_bytes()
        got_f, got_stride = ((frames[m] / sub / f"coord_32x24_{i:04d}.png"
                              ).read_bytes() for m in ("f", "F"))
        assert got_f == want, f"-b f frame {i} differs from the serial run"
        assert (got_stride == want) == (i == 0), f"-b F frame {i}"
