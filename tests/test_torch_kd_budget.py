"""The kd leaf-cell builds, differentially: the port's exact build against
the JAX package's Python recursion, the JAX package's own native exact
build against both (the divergence that keeps its kd-parity test red), the
port's budgeted build (its copy of kdsplit.cc) against the JAX package's to
the bit, the budgeted cells against the exact ones, random600's compiled
tables against the JAX compile's, the raise without the host library, and
on the card the trace and shade kernels on random600's B = 8 gates."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from _torch_common import (aimed_rays, assert_card_shade_variants, jax_scene,
                           port_scene)

EPS = 1e-4        # EPSILON, the kd builds' split slack


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _items(n=80, dim=5, seed=3, inverted=True):
    """The case of tests/test_utils.py::test_native_kd_cells_matches_python:
    n boxes in dim-D from RandomState(seed), row 0 inverted (a
    never-bounded infinite cluster child)."""
    rng = np.random.RandomState(seed)
    c = rng.rand(n, dim) * 60
    lo = c - rng.rand(n, dim) * 4
    hi = c + rng.rand(n, dim) * 4
    if inverted:
        lo[0], hi[0] = np.inf, -np.inf
    return lo, hi


def _jax_python_cells(lo, hi, monkeypatch):
    import ndt_tpu.native as jnative
    from ndt_tpu.utils.kdtree import build_c_exact

    with monkeypatch.context() as m:
        m.setattr(jnative, "kd_cells", lambda *a, **k: None)
        return build_c_exact(lo, hi)


def _key(box):
    return tuple(np.asarray(box).ravel())


def _as_cells(boxes, items, n):
    cells = [[] for _ in range(n)]
    for b, i in zip(boxes, items):
        cells[int(i)].append(b)
    return cells


@pytest.mark.parametrize("n,dim,seed", [(80, 5, 3), (60, 4, 11),
                                        (120, 3, 7)])
def test_port_exact_build_equals_jax_python_build(n, dim, seed,
                                                  monkeypatch):
    """The port's exact build (native/kdcells.cc through
    utils/kdtree.build_c_exact) and its Python recursion both equal the
    JAX package's Python build_c_exact: every item's cells, in order, to
    the bit."""
    from ndt_tpu_torch import native
    from ndt_tpu_torch.utils.kdtree import build_c_exact

    assert native.get_lib() is not None
    lo, hi = _items(n, dim, seed)
    ref = _jax_python_cells(lo, hi, monkeypatch)
    for cells in (build_c_exact(lo, hi), build_c_exact(lo, hi,
                                                       native=False)):
        assert [len(c) for c in cells] == [len(c) for c in ref]
        for a, b in zip(cells, ref):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_jax_native_exact_build_differs_only_in_cell_order(monkeypatch):
    """Why the JAX package's kd-parity test fails: its native exact build
    (ndt_tpu/native/kdsplit.cc) gives every item the same set of cells as
    its Python recursion, bit for bit, but splits the largest node first
    (a priority queue) where the recursion goes depth first, so items 4
    and 77 of the case list their cells in another order.  The gate's
    union, and so the image, is the same."""
    import ndt_tpu.native as jnative
    from ndt_tpu.utils.kdtree import build_c_exact as jbuild

    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native library is unavailable")
    lo, hi = _items()
    ref = _jax_python_cells(lo, hi, monkeypatch)
    nat = jbuild(lo, hi)
    assert [sorted(map(_key, a)) for a in nat] == [sorted(map(_key, b))
                                                   for b in ref]
    reordered = [i for i, (a, b) in enumerate(zip(nat, ref))
                 if [_key(x) for x in a] != [_key(y) for y in b]]
    assert reordered == [4, 77]


KNOBS = [  # max_boxes, node_budget, max_depth, clip_pad, clip_rel
    (8, 20000, 64, 0.02 + EPS, 1e-4),      # the compile's knobs
    (3, 40, 6, 0.02 + EPS, 1e-4),          # truncating
    (2, 20000, 64, -1.0, 0.0),             # merging, unclipped
    (1 << 20, -1, -1, -1.0, 0.0),          # unbounded
]


@pytest.mark.parametrize("knobs", KNOBS)
@pytest.mark.parametrize("case", [(80, 5, 3, True), (150, 5, 9, False)])
def test_budgeted_build_equals_jax(case, knobs):
    """The port's kd_cells_budget (its copy of kdsplit.cc) equals the JAX
    package's ndt_tpu.native.kd_cells_budget to the bit: boxes, items and
    the truncation flag, with the same knobs."""
    import ndt_tpu.native as jnative
    from ndt_tpu_torch import native

    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native library is unavailable")
    lo, hi = _items(*case)
    mb, nb, depth, pad, rel = knobs
    mine = native.kd_cells_budget(lo, hi, EPS, mb, nb, depth, clip_pad=pad,
                                  clip_rel=rel)
    ref = jnative.kd_cells_budget(lo, hi, EPS, mb, nb, depth, clip_pad=pad,
                                  clip_rel=rel)
    np.testing.assert_array_equal(mine[0], ref[0])
    np.testing.assert_array_equal(mine[1], ref[1])
    assert mine[2] == ref[2]
    assert mine[2] == (knobs == KNOBS[1])


@pytest.mark.parametrize("merged", [False, True])
def test_budgeted_cells_cover_the_exact_cells(merged):
    """Without truncation the budgeted recursion is the exact one: with no
    merge and no clip each item has the exact build's cells (as a set:
    the budgeted build walks largest node first); with the compile's
    merge into 8 boxes and its clip, every exact cell of an item, clipped
    to the item's padded box, lies inside one of the item's boxes.  The
    inverted row 0 leaves the tree at the first split in both builds and
    has no cell."""
    from ndt_tpu_torch import native
    from ndt_tpu_torch.utils.kdtree import build_c_exact

    lo, hi = _items()
    exact = build_c_exact(lo, hi)
    if not merged:
        boxes, items, trunc = native.kd_cells_budget(lo, hi, EPS, 1 << 20,
                                                     -1, -1)
        assert not trunc
        cells = _as_cells(boxes, items, len(lo))
        assert [sorted(map(_key, a)) for a in cells] == [
            sorted(map(_key, b)) for b in exact]
        return
    pad, rel = 0.02 + EPS, 1e-4
    boxes, items, trunc = native.kd_cells_budget(lo, hi, EPS, 8, 20000, 64,
                                                 clip_pad=pad, clip_rel=rel)
    assert not trunc
    cells = _as_cells(boxes, items, len(lo))
    assert cells[0] == exact[0] == []
    for i, (mine, ref) in enumerate(zip(cells, exact)):
        if i == 0:
            continue
        assert 1 <= len(mine) <= 8
        p = pad + rel * np.maximum(np.abs(lo[i]), np.abs(hi[i]))
        for cell in ref:
            c_lo = np.maximum(cell[:, 0], lo[i] - p)
            c_hi = np.minimum(cell[:, 1], hi[i] + p)
            assert any(((b[:, 0] <= c_lo) & (c_hi <= b[:, 1])).all()
                       for b in mine), i


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*a, **k)


def test_random600_tables_equal_jax():
    """random "600" 5-D (600 kd items: 77 hcubes' faces, facets, hfacets,
    10,533 leaves) compiled by the port equals the JAX compile to the bit,
    every block field and kernel table, the budgeted gates (B = 8)
    included; the compile warns as the JAX package's does."""
    from ndt_tpu.scene.compile import compile_scene as jcompile
    from ndt_tpu_torch.scene import compile_scene, scene_from_numpy, to_device
    from ndt_tpu_torch.scene.compile import pack_tables

    jsd = _quiet(jcompile, jax_scene("random", 5, config="600"), np.float32)
    with pytest.warns(RuntimeWarning, match="BUDGETED"):
        psd = compile_scene(port_scene("random", 5, config="600"),
                            np.float32)
    for fam in ("spheres", "planes", "quadrics", "facets", "hfacets"):
        pblk, jblk = getattr(psd, fam), getattr(jsd, fam)
        for f in dataclasses.fields(pblk):
            a, b = getattr(pblk, f.name), np.asarray(getattr(jblk, f.name))
            assert a.dtype == b.dtype and a.shape == b.shape, (fam, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{fam}.{f.name}")
    mine, ref = pack_tables(psd), pack_tables(scene_from_numpy(jsd))
    for k in mine:
        np.testing.assert_array_equal(mine[k], ref[k], k)
    dev = to_device(psd, "cpu")
    assert dev.n_total == 10533
    assert (dev.b_gate, dev.b_fct, dev.b_hf) == (8, 8, 8)


def test_budgeted_gates_raise_without_the_host_library(monkeypatch):
    """Without the host library a scene past the exact cap raises: the
    budgeted build has no Python path, and per-item boxes would render
    another image than the JAX package's."""
    from ndt_tpu_torch import native
    from ndt_tpu_torch.scene import compile_scene

    from _torch_common import many_items_scene

    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="host library"):
        compile_scene(many_items_scene(port=True))


# --------------------------------------------------------------------------
# on the card


@pytest.mark.gpu
def test_random600_gates_on_card():
    """On the card: random600's B = 8 budgeted gates (quadric slots, facet
    and hfacet tables) through the trace kernel's three modes with the
    early exit, against the twins, every output to the bit; and every
    shade variant against its twin at the shading bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.scene import compile_scene, to_device

    host = _quiet(compile_scene, port_scene("random", 5, config="600"))
    scn = to_device(host, "cuda")
    assert scn.b_gate == scn.b_fct == scn.b_hf == 8
    o, v, live = (torch.as_tensor(x, device="cuda") for x in
                  aimed_rays(host, [30, 30, -30, 30, 0], seed=6,
                             R=2 * 4096))
    rng = np.random.default_rng(2)
    lim = torch.as_tensor(rng.uniform(5, 80, o.shape[0]).astype(np.float32),
                          device="cuda")
    none = torch.full((o.shape[0],), -1, dtype=torch.int32, device="cuda")
    before = dict(K.launch_counts)
    for name, aux, limit in (("trace_closest", none, None),
                             ("trace_any", none, None),
                             ("trace_shadow", lim, lim)):
        cull = K.cull_lists(scn, o, v, live=live, limit=limit,
                            want_reach=True) + (live,)
        got = getattr(K, name)(scn, o, v, aux, *cull)
        ref = getattr(K, name + "_ref")(scn, o, v, aux, *cull)
        torch.cuda.synchronize()
        assert (ref[0] < 5e29).any(), name
        for a, b in zip(got, ref):
            same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
                if a.is_floating_point() else a == b
            assert bool(same.all()), (name, int((~same).sum()))
    assert K.launch_counts["trace_early_exit"] == (
        before["trace_early_exit"] + 3)
    assert_card_shade_variants(scn, o, v, live, ("p",) * 5, facets=True)
