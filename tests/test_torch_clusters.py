"""Clusters in the port against the JAX package: k-means labels and the
cluster tree, Scene.cluster and the scene helpers, the transforms'
recursion into a cluster, the compile's walk of clusters (the kd-parity
quirk of infinite children), cluster5d's tables to the bit (plain and
regrouped by Scene.cluster(3)) and its 64x48 frame; Scene.cluster leaves
the port's frame unchanged.

Bars: labels, trees, objects and tables to the bit; frames < 0.2% of pixels
off by > 1e-3 (the reference's f32 frame bar, ROADMAP)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from _torch_common import (assert_same, jax_scene, object_tree, port_scene,
                           regrouped)

W, H = 64, 48


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,dim,k,seed", [(40, 5, 4, 0), (40, 5, 3, 0),
                                          (200, 3, 7, 5), (9, 4, 12, 1)])
def test_kmeans_labels_equal_jax(n, dim, k, seed):
    """kmeans seeds its centres from np.random.RandomState, as the JAX
    package does: the same labels on the same points (k > n included)."""
    from ndt_tpu.utils.kmeans import kmeans as jkmeans
    from ndt_tpu_torch.utils.kmeans import kmeans

    pts = np.random.default_rng(n + k).normal(scale=10.0, size=(n, dim))
    np.testing.assert_array_equal(kmeans(pts, k, seed=seed),
                                  jkmeans(pts, k, seed=seed))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_build_cluster_tree_equals_jax(k):
    """build_cluster_tree over cluster5d's 40 spheres: the same tree
    (depths, names, the same spheres in the same leaves in the same
    order) as the JAX package's, built from the port's Objects."""
    from ndt_tpu.utils.kmeans import build_cluster_tree as jbuild
    from ndt_tpu_torch.scene.model import Object
    from ndt_tpu_torch.utils.kmeans import build_cluster_tree

    pscn, jscn = port_scene("cluster5d", 5), jax_scene("cluster5d", 5)
    ptree = build_cluster_tree(5, pscn.objects[1].children, k)
    jtree = jbuild(5, jscn.objects[1].children, k)
    assert isinstance(ptree, Object)

    def names(o):
        return (o.type_name, o.name, list(o.flag),
                [names(c) for c in o.children])

    assert names(ptree) == names(jtree)
    assert_same(object_tree(ptree), object_tree(jtree))
    assert len(ptree.children) > 1


def test_scene_cluster_equals_jax():
    """Scene.cluster(3) on cluster5d with an extra infinite hplane and a
    top-level sphere: the same tree, bounds included, and the infinite
    objects stay at top level after the cluster, as in the JAX package."""
    scns = []
    for pscn in (port_scene("cluster5d", 5), jax_scene("cluster5d", 5)):
        wall = pscn.add_object("hplane", "wall")
        wall.add_pos(np.array([0, 0, -30.0, 0, 0])).add_dir(
            np.array([0, 0, 1.0, 0, 0]))
        pscn.add_object("sphere", "lone").add_pos(
            np.array([5.0, 20, 0, 0, 0])).add_size(2.0)
        pscn.cluster(3)
        scns.append(pscn)
    pscn, jscn = scns
    assert [o.type_name for o in pscn.objects] == ["cluster", "hplane",
                                                   "hplane"]
    assert_same([object_tree(o) for o in pscn.objects],
                [object_tree(o) for o in jscn.objects])


def test_transforms_recurse_into_clusters():
    """move, rotate and rotate2 on hypercube's cluster turn every child,
    the flag-2 edge hcylinders (which never render) included, and equal
    the JAX package's transforms to the bit."""
    out = []
    for scn in (port_scene("hypercube", 4), jax_scene("hypercube", 4)):
        clus = scn.objects[-1]
        for c in clus.children:
            c.get_bounds()
        clus.move(np.array([1.0, -2.0, 0.5, 3.0]))
        clus.rotate(np.array([0.5, 0, 0, 1.0]), 1, 3, 0.3)
        clus.rotate2(np.zeros(4), np.array([0, 1.0, 0, 0]),
                     np.array([1.0, 1, 1, 1]), 1.1)
        out.append(scn)
    assert_same(object_tree(out[0].objects[-1]),
                object_tree(out[1].objects[-1]))
    before = port_scene("hypercube", 4).objects[-1].children
    after = out[0].objects[-1].children
    for a, b in zip(after, before):
        assert all(not np.array_equal(p, q) for p, q in zip(a.pos, b.pos))
    hcyl = [c for c in after if c.type_name == "hcylinder"]
    assert len(hcyl) == 24 and all(c.flag == [2] for c in hcyl)


def test_scene_helpers_equal_jax():
    """describe, find_dupes, remove_dupes and remove_object give the JAX
    package's results."""
    scns = []
    for scn in (port_scene("hypercube-points", 4),
                jax_scene("hypercube-points", 4)):
        first = scn.objects[1]
        dup = scn.add_object(first.type_name, "copy")
        dup.add_pos(first.pos[0]).add_size(first.size[0])
        scn.add_object("hplane", "floor 2").add_pos(
            scn.objects[0].pos[0]).add_dir(scn.objects[0].dir[0])
        scns.append(scn)
    pscn, jscn = scns
    assert pscn.describe() == jscn.describe()
    assert ([o.name for o in pscn.find_dupes()]
            == [o.name for o in jscn.find_dupes()] == ["copy", "floor 2"])
    for scn in scns:
        scn.remove_dupes()
        scn.remove_object(scn.objects[-1])
    assert [o.name for o in pscn.objects] == [o.name for o in jscn.objects]
    assert pscn.describe() == jscn.describe()


def test_flatten_keeps_the_kd_parity_quirk():
    """hypercube's compile: every cluster child takes a kd item (80), the
    24 infinite flag-2 hcylinders included, but those yield no leaf: the
    floor, 8 orthotopes, 32 cylinders and 16 spheres, each with its own
    material; the hcylinders' items keep the inverted empty box."""
    from ndt_tpu_torch.scene.compile import _flatten

    scn = port_scene("hypercube", 4)
    leaves, materials, items = _flatten(scn.objects, 4)
    assert len(items) == 80
    assert len(leaves) == len(materials) == 57
    assert {leaf.obj.type_name for leaf in leaves} == {
        "hplane", "orthotope", "cylinder", "sphere"}
    assert leaves[0].kd_item == -1 and leaves[0].shadow_rank is not None
    inverted = [k for k, (lo, hi) in enumerate(items) if np.isinf(lo).all()]
    assert len(inverted) == 24 and all(np.isneginf(items[k][1]).all()
                                       for k in inverted)
    assert sorted({leaf.kd_item for leaf in leaves[1:]}) == sorted(
        set(range(80)) - set(inverted))


@pytest.mark.parametrize("how", ["plain", "cluster3", "regrouped"])
def test_cluster5d_tables_equal_jax(how):
    """cluster5d compiled by the port equals the JAX compile to the bit,
    every block and kernel table: as built, after Scene.cluster(3), and
    regrouped by k-means (the labels decide the leaf order)."""
    from ndt_tpu.scene.compile import compile_scene as jcompile
    from ndt_tpu_torch.scene import compile_scene, scene_from_numpy
    from ndt_tpu_torch.scene.compile import pack_tables

    pscn, jscn = port_scene("cluster5d", 5), jax_scene("cluster5d", 5)
    if how == "cluster3":
        pscn.cluster(3)
        jscn.cluster(3)
    elif how == "regrouped":
        regrouped(pscn)
        regrouped(jscn)
        assert len(pscn.objects[0].children) > 1
    jsd = jcompile(jscn, np.float32)
    psd = compile_scene(pscn, np.float32)
    for fam in ("spheres", "planes"):
        pblk, jblk = getattr(psd, fam), getattr(jsd, fam)
        for f in dataclasses.fields(pblk):
            np.testing.assert_array_equal(getattr(pblk, f.name),
                                          np.asarray(getattr(jblk, f.name)),
                                          err_msg=f"{fam}.{f.name}")
    mine, ref = pack_tables(psd), pack_tables(scene_from_numpy(jsd))
    assert mine.keys() == ref.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], ref[k], k)
    assert psd.spheres.center.shape[0] == 40 and psd.n_materials == 41


def test_cluster5d_frame_matches_jax_engine():
    """cluster5d 5-D at 64x48 through render_frame on the CPU twins
    against the JAX engine's frame through its interpret-mode kernels
    (whose walks the twins follow): < 0.2% of pixels off by > 1e-3."""
    from ndt_tpu.render import engine as jengine
    from ndt_tpu.render import trace as jtrace
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    jtrace.set_trace_impl("pallas-interpret")
    try:
        jimg, _, jrays = jengine.render_frame(
            jax_scene("cluster5d", 5), jengine.RenderOptions(width=W,
                                                             height=H))
    finally:
        jtrace.set_trace_impl("auto")
    img, _, rays = render_frame(port_scene("cluster5d", 5),
                                RenderOptions(width=W, height=H),
                                device="cpu")
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    d = np.abs(img - np.asarray(jimg)).max(-1)
    assert (d > 1e-3).mean() < 0.002, d.max()
    assert math.isclose(rays, jrays, rel_tol=1e-3)


@pytest.mark.parametrize("how", ["cluster3", "regrouped"])
def test_scene_cluster_leaves_the_frame_unchanged(how):
    """The port's Scene.cluster(3) on cluster5d, and its k-means regrouping
    of the 40 spheres (another leaf order), leave the 64x48 frame equal to
    the plain one."""
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    opts = RenderOptions(width=W, height=H)
    plain, _, n0 = render_frame(port_scene("cluster5d", 5), opts,
                                device="cpu")
    scn = port_scene("cluster5d", 5)
    if how == "cluster3":
        scn.cluster(3)
    else:
        regrouped(scn)
    assert [o.type_name for o in scn.objects] == ["cluster", "hplane"]
    wrapped, _, n1 = render_frame(scn, opts, device="cpu")
    np.testing.assert_array_equal(wrapped, plain)
    assert n0 == n1
