"""Whole runs of the harness: on the CPU at a tiny size (the kernels'
plain twins in the program's place of the CUDA kernels), and with the
``gpu`` marker on the card at the cells' own sizes.

A sound run comes out correct and leaves no module of JAX or of the JAX
package loaded.  A run whose timed path is broken underneath comes out
not correct: a bounce step that returns its state unchanged, every other
ray of a batch left out (their pixels show the background, as a miss
would), the shading's colour altered where it is produced.  So does each
cell's control (``portbench/control.py``): the reference in bfloat16 put
in the program's place (float32 cells) and the program's float32 path
(the float64 cell).  Each prints the numbers it was judged by.  Without
a card, ``run.py`` exits 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import control, harness  # noqa: E402

SEED = 2 ** 31 + 97
# the CPU runs' frame sizes: the program's CPU twins are slow, and
# random-5d-150's camera sees its objects in ~2% of the pixels, and
# random-5d-600's frame compiles 10533 leaves, so only the balls cells run
# on the CPU; every cell runs on the card
CPU_SIZES = {"balls4d_1080p_anim": (48, 32), "balls4d_1080p_f64": (48, 32)}
CELLS = ["balls4d_1080p_anim", "random5d_150_static", "balls4d_1080p_f64",
         "random5d_600_static"]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _cell(name, device):
    cell = harness.resolve(name)
    if device == "cpu":
        w, h = CPU_SIZES[name]
        cell = dataclasses.replace(cell, traffic=dict(
            cell.traffic, width=w, height=h, pool_frames=40))
    return cell


def _run(name, device, seconds=None, trace=False):
    seconds = (1.0 if device == "cpu" else 2.0) if seconds is None \
        else seconds
    return harness.run_cell(_cell(name, device), SEED, seconds, trace,
                            device)[0]


def _params():
    out = []
    for name in CELLS:
        if name in CPU_SIZES:
            out.append(pytest.param(name, "cpu", id=f"{name}-cpu"))
        out.append(pytest.param(name, "cuda", id=f"{name}-cuda",
                                marks=pytest.mark.gpu))
    return out


@pytest.mark.parametrize("name, device", _params())
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(name, device, trace):
    if device == "cuda":
        _needs_card()
    res = _run(name, device, trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert not harness.forbidden_modules()


def _stuck_step(monkeypatch):
    from ndt_tpu_torch.render import engine

    monkeypatch.setattr(engine, "_chain_body",
                        lambda scn, li, carry, opts, gen=None,
                        escalate=False: (carry[0] + 1,) + tuple(carry[1:]))
    monkeypatch.setattr(engine, "_stack_body",
                        lambda scn, li, carry, opts, gen=None:
                        (carry[0] + 1,) + tuple(carry[1:]))


def _half_batch(monkeypatch):
    """Every other ray of each batch left out (so the rays left out cover
    the objects as the ones traced do); their pixels get the background
    colour, as a ray that missed everything would."""
    from ndt_tpu_torch.render import engine

    inner = engine.render_rays_chunked

    def half(scn, o, v, opts, gen=None):
        c, d, n = inner(scn, o[::2], v[::2], opts, gen)
        col = torch.as_tensor(scn.host.bg, dtype=c.dtype, device=c.device)
        col = col.expand(o.shape[0], 3).clone()
        dep = d.new_zeros(o.shape[0])
        col[::2], dep[::2] = c, d
        return col, dep, n

    monkeypatch.setattr(engine, "render_rays_chunked", half)


def _altered_colour(monkeypatch):
    from ndt_tpu_torch.render import engine, trace

    carry, local, lights = trace.shade_carry, trace.shade_local, \
        engine.apply_lights
    monkeypatch.setattr(trace, "shade_carry", lambda *a, **k: tuple(
        x * 0.9 if i == 4 else x for i, x in enumerate(carry(*a, **k))))
    monkeypatch.setattr(trace, "shade_local",
                        lambda *a, **k: local(*a, **k) * 0.9)
    monkeypatch.setattr(engine, "apply_lights",
                        lambda *a, **k: lights(*a, **k) * 0.9)


FAULTS = {"stuck_step": _stuck_step, "half_batch": _half_batch,
          "altered_colour": _altered_colour}


@pytest.mark.parametrize("name, device", _params())
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(name, device, fault, monkeypatch):
    if device == "cuda":
        _needs_card()
    FAULTS[fault](monkeypatch)
    res = _run(name, device)
    print(f"[fault] {name} {device} {fault}: {json.dumps(res['checks'])}")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name, device", _params())
def test_control_is_not_correct(name, device):
    """The cell's control fails its check: the program's own lower
    precision where it has one, else the reference in the next precision
    down, put in the program's place."""
    if device == "cuda":
        _needs_card()
    with control.control(_cell(name, device)) as cell:
        res = harness.run_cell(cell, SEED, 1.0 if device == "cpu" else 2.0,
                               False, device)[0]
    print(f"[control] {name} {device}: {json.dumps(res['checks'])}")
    assert not res["correct"], res["checks"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "balls4d_1080p_anim", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and not out.stdout.strip()


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "balls4d_1080p_anim", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_no_jax_after_a_run():
    code = (f"import sys, dataclasses\nsys.path.insert(0, {ROOT!r})\n"
            "from portbench import harness\n"
            "cell = harness.resolve('balls4d_1080p_anim')\n"
            "cell = dataclasses.replace(cell, traffic=dict(cell.traffic, "
            "width=16, height=12, pool_frames=20))\n"
            "res, _ = harness.run_cell(cell, 5, 0.5, True, 'cpu')\n"
            "assert res['correct']\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
