"""The reference's kd leaf cells against the program's.

Past ``KD_EXACT_MAX`` kd items the reference's budgeted build
(``portbench/reference/kd_budget.py``, plain numpy) gives every item the
same boxes, in the same order, as the program's ``compile._budgeted_cells``
(its C++ ``native.kd_cells_budget``), to the bit; up to it the reference
builds the C's exact tree, box for box the program's ``build_c_exact``.
The items are random-5d-600's own and seeded sets at D = 3, 5 and 6.
Every item reaches some leaf (each split sends an item to one side at
least), so no item takes the fallback of its own box on either side.
"""

from __future__ import annotations

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import scenegen  # noqa: E402
from portbench.reference import kd_budget, scene  # noqa: E402


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs",
                           f"{name}.json")) as f:
        return json.load(f)


def _scene_items(name):
    """The kd items' boxes [n, D] of a configuration's scene, as the
    program flattens its host scene."""
    from ndt_tpu_torch.scene import compile as program

    data = scenegen.frames(_config(name), 2 ** 31 + 3).frame(0)
    scn = scenegen.to_program_scene(data)
    _, _, items = program._flatten(scn.objects, scn.dim)
    return (np.stack([lo for lo, _ in items]),
            np.stack([hi for _, hi in items]))


def _seeded_items(n, dim):
    rng = np.random.default_rng([n, dim])
    center = rng.uniform(2.0, 12.0, (n, dim))
    half = rng.uniform(0.05, 3.0, (n, dim))
    return center - half, center + half


def _same_cells(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert len(x) == len(y), f"item {i}: {len(x)} boxes, {len(y)}"
        for k, (p, q) in enumerate(zip(x, y)):
            assert p.shape == q.shape and p.dtype == q.dtype
            assert np.array_equal(p, q), f"item {i} box {k}"


@pytest.mark.parametrize("case", ["random-5d-600", "257x3", "600x5",
                                  "1200x6"])
def test_budgeted_cells_equal_the_programs(case):
    from ndt_tpu_torch.scene import compile as program

    if case.startswith("random"):
        lowers, uppers = _scene_items(case)
    else:
        n, dim = map(int, case.split("x"))
        lowers, uppers = _seeded_items(n, dim)
    assert len(lowers) > scene.KD_EXACT_MAX
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        theirs = program._budgeted_cells(lowers, uppers)
    ours = kd_budget.budgeted_cells(lowers, uppers)
    _same_cells(ours, theirs)
    # the cap and the clip bind: merged boxes, inside the padded item box
    assert max(len(c) for c in ours) == kd_budget.MAX_BOXES
    pad = kd_budget.CLIP_PAD + kd_budget.CLIP_REL * np.maximum(
        np.abs(lowers), np.abs(uppers)) + 1e-12
    for i, cells in enumerate(ours):
        for box in cells:
            assert (box[:, 0] >= lowers[i] - pad[i]).all()
            assert (box[:, 1] <= uppers[i] + pad[i]).all()


def test_exact_tree_up_to_256_items(monkeypatch):
    """random-5d-150's 150 items take the exact tree, never the budgeted
    build, and its cells are the program's exact ones."""
    from ndt_tpu_torch.utils.kdtree import build_c_exact

    seen = []
    exact = scene.kd_leaf_cells

    def recorded(lowers, uppers):
        seen.append((lowers, uppers))
        return exact(lowers, uppers)

    def refused(lowers, uppers):
        raise AssertionError("the budgeted build ran for <= 256 items")

    monkeypatch.setattr(scene, "kd_leaf_cells", recorded)
    monkeypatch.setattr(scene, "budgeted_cells", refused)
    data = scenegen.frames(_config("random-5d-150"), 5).frame(0)
    built = scene.build_scene(data, torch.float64, "cpu")
    (lowers, uppers), = seen
    assert len(lowers) == 150
    assert any(hasattr(blk, "gate_plo") and blk.gate_plo.shape[1]
               for _, blk in built.blocks)
    _same_cells(exact(lowers, uppers), build_c_exact(lowers, uppers))
