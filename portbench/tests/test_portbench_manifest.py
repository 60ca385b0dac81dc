"""BENCHMARK.json and the files it names: every cell resolves to its
configuration, its scene generator, its traffic mix, its limits and the
readers of its per-layer metrics, by name alone, and the manifest keeps
to the benchmark's contract."""

from __future__ import annotations

import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness, scenegen  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = harness.resolve(cell)
    assert c.limits["checks"] and set(c.limits["checks"]) <= \
        set(harness.CHECKS)
    assert all(v > 0 for v in c.limits["checks"].values())
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m, reader in c.per_layer:
        assert callable(reader.read)
    for key in ("dtype", "width", "height", "max_optic_depth",
                "pool_frames", "warmup_frames", "trace_frames",
                "check_frames"):
        assert key in c.traffic
    frame = scenegen.frames(c.config, 2 ** 31 + 7).frame(3)
    assert frame["dim"] == c.config["dim"]
    assert len(frame["objects"]) == c.config["objects"]


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_seed_keeps_the_work(config):
    """Two seeds render the same kinds and counts of objects and glass
    (balls: frames from another start; random: the one scene); one seed
    renders the same inputs each time."""
    entry = {c["name"]: c for c in BENCH["configs"]}[config]
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)

    def first(seed):
        src = scenegen.frames(cfg, seed)
        return src.frame(int(src.order(20)[0]))

    a, b, again = first(1), first(2 ** 31 + 11), first(1)
    for x, y in ((a, b), (a, again)):
        assert sorted(o["type"] for o in x["objects"]) == \
            sorted(o["type"] for o in y["objects"])
        assert sum(o["transparent"] for o in x["objects"]) == \
            sum(o["transparent"] for o in y["objects"])

    def pos(x):
        return [p for o in x["objects"] for p in o["pos"]]

    assert all((p == q).all() for p, q in zip(pos(a), pos(again)))
    moved = any(not (p == q).all() for p, q in zip(pos(a), pos(b)))
    assert moved == (cfg["generator"] == "balls_anim")


@pytest.mark.parametrize("config, count", [("random-5d-150", "150"),
                                           ("random-5d-600", "600")])
def test_random_generator_draws_the_c_scene(config, count):
    """A random configuration's objects and lights are the C's own draw
    (the program's random scene module follows the C's drand48 stream),
    in the C's order."""
    from ndt_tpu_torch.scene import Scene
    from ndt_tpu_torch.scenes import get_scene

    entry = {c["name"]: c for c in BENCH["configs"]}[config]
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    data = scenegen.frames(cfg, 2 ** 31 + 3).frame(0)
    objs = data["objects"]
    scn = Scene("random", cfg["dim"])
    get_scene("random").scene_setup(scn, cfg["dim"], 0, 1, count)
    assert len(objs) == len(scn.objects) == cfg["objects"]
    for o, c in zip(objs, scn.objects):
        assert o["type"] == c.type_name and o["flag"] == c.flag
        assert o["size"] == c.size and o["transparent"] == c.transparent
        assert list(o["color"]) == list(c.color) and o["ior"] == \
            c.refract_index
        for a, b in zip(o["pos"] + o["dir"], c.pos + c.dir):
            assert (a == b).all()
    for lgt, c in zip(data["lights"], scn.lights):
        assert (lgt["pos"] == c.pos).all()


def test_balls_generator_starts_as_the_c():
    """balls-4d-1080p's balls start where balls.c's srand48(1) draw puts
    them (the program's balls module replays that draw), and a run renders
    consecutive frames of that one animation from a start the seed picks,
    on to frame 0 after its last."""
    from ndt_tpu_torch.scenes import balls

    from portbench.scenes.balls_anim import Frames

    entry = {c["name"]: c for c in BENCH["configs"]}["balls-4d-1080p"]
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    start = balls._init_balls(cfg["dim"])
    a, b = Frames(cfg, 1), Frames(cfg, 2 ** 31 + 5)
    for ours, c in ((a.radius, "radius"), (a.color, "color"),
                    (a.pos0, "pos"), (a.vel, "vel")):
        assert (ours == start[c]).all()
    count = cfg["animation_frames"]
    for src in (a, b):
        frames = src.order(count + 1)
        assert sorted(frames[:count]) == list(range(count))
        assert all((frames[1:] - frames[:-1]) % count == 1)
    assert a.order(1)[0] != b.order(1)[0]
