"""The port's Whitted anti-aliasing and adaptive sampling against the JAX
package: Whitted frames and their resample counts at aperture 0 (which
makes them deterministic), whitted_refine on the same corner grid, the
adaptive loop's bookkeeping under one deterministic fake sampler, and the
JAX package's behavioural checks of both (tests/test_adaptive.py).  Small
scenes on the CPU (the kernels' twins)."""

import collections
import types

import numpy as np
import pytest
import torch

from _torch_common import assert_frame_bar
from test_torch_cameras import mini_scene


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def adaptive_scene(port):
    """tests/test_adaptive.py's scene: the small scene without
    reflection."""
    return mini_scene(port, reflect=0.0)


@pytest.fixture
def flagged_counts(monkeypatch):
    """Record the resampled (flagged) pixel count of every whitted_refine
    call of either package, per package."""
    from ndt_tpu.render import adaptive as jax_adaptive
    from ndt_tpu_torch.render import adaptive

    counts = {"jax": [], "port": []}
    for key, mod in (("jax", jax_adaptive), ("port", adaptive)):
        orig = mod.whitted_refine

        def wrapped(*a, _orig=orig, _key=key, **k):
            out = _orig(*a, **k)
            counts[_key].append(out[1])
            return out

        monkeypatch.setattr(mod, "whitted_refine", wrapped)
    return counts


@pytest.mark.parametrize("stereo,depth", [
    ("mono", 3), ("side", 2), ("over", 2), ("anaglyph", 2)])
def test_whitted_frames_match_jax(stereo, depth, flagged_counts):
    """-w at 32x24 (aa_diff 8) in every layout: the frame meets the f32
    frame bar against the JAX package and each eye panel resamples the
    same number of pixels."""
    from ndt_tpu.render.engine import RenderOptions as JOpts
    from ndt_tpu.render.engine import render_frame as jax_render_frame
    from ndt_tpu_torch.render import adaptive
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    kw = dict(width=32, height=24, max_optic_depth=3, stereo=stereo,
              whitted=True, aa_diff=8, aa_depth=depth)
    ref, _, _ = jax_render_frame(mini_scene(False), JOpts(tile=1024, **kw))
    img, _, n = render_frame(mini_scene(True), RenderOptions(**kw),
                             device="cpu")
    assert_frame_bar(img, np.asarray(ref))
    assert flagged_counts["port"] == flagged_counts["jax"]
    assert sum(flagged_counts["port"]) > 0
    # the first level of each panel renders 5 midpoints per flagged pixel
    first = [r["points"] for r in adaptive.history
             if r["kind"] == "whitted" and r["index"] == 1]
    assert sum(first) == 5 * sum(flagged_counts["port"])
    assert n == sum(r["rays"] for r in adaptive.history)


def test_whitted_refine_matches_jax_on_the_same_corners():
    """Both packages' whitted_refine on one corner grid (the JAX
    package's): the same resampled pixels, and images within the frame
    bar (the midpoints each renders itself)."""
    import dataclasses

    import jax

    from ndt_tpu.render.adaptive import whitted_refine as jax_refine
    from ndt_tpu.render.engine import RenderOptions as JOpts
    from ndt_tpu.render.engine import _render_grid as jax_grid
    from ndt_tpu.scene.compile import compile_scene as jax_compile
    from ndt_tpu_torch.render.adaptive import whitted_refine
    from ndt_tpu_torch.render.engine import RenderOptions, frame_camera
    from ndt_tpu_torch.scene import compile_scene, to_device

    W, H = 32, 24
    jopts = JOpts(width=W, height=H, max_optic_depth=3, tile=1024)
    j = mini_scene(False).cam.aim()
    jcd = j.data(np.float32)
    jcd = dataclasses.replace(jcd, dir_x=jcd.dir_x * np.float32(W / H))
    jsd = jax_compile(mini_scene(False), np.float32)
    amap = (1.0 / (W + 1), -0.5, -1.0 / (H + 1), 0.5)
    gx, gy = np.arange(W + 1, dtype=np.float32), np.arange(H + 1,
                                                           dtype=np.float32)
    xg, yg = np.meshgrid((amap[0] * gx + amap[1]).astype(np.float32),
                         (amap[2] * gy + amap[3]).astype(np.float32))
    key = jax.random.PRNGKey(0)
    c, _, _ = jax_grid(jsd, jcd, xg, yg, jopts, "center", key)
    corners = np.asarray(c).reshape(H + 1, W + 1, 3)
    ref, jn, _ = jax_refine(jsd, jcd, corners, jopts, 8, 3, key)

    opts = RenderOptions(width=W, height=H, max_optic_depth=3)
    cam = frame_camera(mini_scene(True), opts, "cpu")
    sd = to_device(compile_scene(mini_scene(True)), "cpu")
    img, n, extra = whitted_refine(sd, cam, corners, opts, 8, 3)
    assert n == jn > 0 and extra > 0
    assert_frame_bar(img, np.asarray(ref))


class FakeSampler:
    """One deterministic sampler for both packages' adaptive loops: a
    sample's colour is a smooth function of its screen point plus, right
    of x = 0, a hash-noise term of the round; its depth the round.  It
    counts the samples of every point ((0, 0), the JAX package's padding,
    is not a pixel here)."""

    def __init__(self):
        self.round = 0
        self.count = collections.Counter()

    def sample(self, x, y):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        r = self.round
        self.round += 1
        for p in zip(x.tolist(), y.tolist()):
            if p != (0.0, 0.0):
                self.count[p] += 1
        h = np.sin(x * 12.9898 + y * 78.233 + r * 0.7123) * 43758.5453
        noise = np.where(x > 0, 0.3 * (h - np.floor(h)) - 0.15, 0.0)
        base = 0.5 + 0.4 * np.sin(37 * x + 11 * y)
        c = np.stack([base + noise, base, base - noise], -1)
        return c.astype(np.float32), np.full(x.shape, r, np.float32)


def test_adaptive_bookkeeping_matches_jax(monkeypatch):
    """render_adaptive_samples of both packages under one fake sampler
    (their gen_rays and render_rays_chunked replaced): the per-pixel
    sample counts, colours and depths are equal."""
    import jax
    import jax.numpy as jnp

    from ndt_tpu.render import adaptive as jax_adaptive
    from ndt_tpu.render.engine import RenderOptions as JOpts
    from ndt_tpu_torch.render import adaptive, engine
    from ndt_tpu_torch.render.engine import RenderOptions

    xs, ys = np.meshgrid(np.arange(16, dtype=np.float32) / 16 - 0.47,
                         -(np.arange(12, dtype=np.float32) / 12 - 0.46))
    x, y = xs.ravel(), ys.ravel()
    jf, pf = FakeSampler(), FakeSampler()

    def jax_gen(cam, x, y, key, opts, eye, jitter, aperture):
        o = jnp.stack([x, y], -1)
        return o, o

    def jax_render(scene, o, v, key, opts):
        c, d = jf.sample(np.asarray(o)[:, 0], np.asarray(o)[:, 1])
        return jnp.asarray(c), jnp.asarray(d), jnp.int32(len(d))

    def port_gen(cam, x, y, eye="center", jitter=None, aperture=False,
                 gen=None):
        assert jitter == (16, 12) and aperture
        o = torch.stack([x, y], -1)
        return o, o

    def port_render(scn, o, v, opts, gen=None):
        c, d = pf.sample(o[:, 0].numpy(), o[:, 1].numpy())
        return torch.as_tensor(c), torch.as_tensor(d), torch.tensor(len(d))

    monkeypatch.setattr(jax_adaptive, "gen_rays", jax_gen)
    monkeypatch.setattr(jax_adaptive, "render_rays_chunked", jax_render)
    monkeypatch.setattr(engine, "gen_rays", port_gen)
    monkeypatch.setattr(engine, "render_rays_chunked", port_render)

    jc, jd, _ = jax_adaptive.render_adaptive_samples(
        None, None, x, y, jax.random.PRNGKey(0),
        JOpts(width=16, height=12, samples=4), "center")
    pc, pd, n = adaptive.render_adaptive_samples(
        types.SimpleNamespace(device=torch.device("cpu")), None, x, y,
        RenderOptions(width=16, height=12, samples=4))
    assert pf.count == jf.count
    counts = np.array([pf.count[p] for p in zip(x.tolist(), y.tolist())])
    # the (m-2)/(m-1) quirk stops noiseless pixels by (m-2)(m-1) >= 256 s
    # (s <= 0.9 here: m <= 17); the noisy half samples longer
    assert counts.min() >= 4 and counts[x <= 0].max() <= 17
    assert counts[x > 0].max() > 17
    np.testing.assert_array_equal(pc, np.asarray(jc))
    np.testing.assert_array_equal(pd, np.asarray(jd))
    assert n == counts.sum() and pf.round == jf.round
    assert [r["points"] for r in adaptive.history[-pf.round:]][0] == len(x)


def test_whitted_refines_edges():
    """tests/test_adaptive.py's check on the port: the corner grid and the
    refinement trace more rays and smooth the silhouette."""
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    base = RenderOptions(width=48, height=36, max_optic_depth=3)
    img0, _, n0 = render_frame(adaptive_scene(True), base, device="cpu")
    img1, _, n1 = render_frame(adaptive_scene(True), RenderOptions(
        width=48, height=36, max_optic_depth=3, whitted=True, aa_diff=8,
        aa_depth=3), device="cpu")
    assert np.isfinite(img1).all()
    assert n1 > n0
    assert np.abs(img0 - img1).max() > 0.01


def test_whitted_flat_region_unrefined():
    """A uniform background needs no refinement: the Whitted frame is the
    background almost everywhere."""
    from ndt_tpu_torch.render import adaptive
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    scn = adaptive_scene(True)
    scn.objects = []
    s = scn.add_object("sphere", "tiny")
    s.add_pos(np.array([100.0, 100, 100, 0])).add_size(0.1)
    s.set_color(1, 1, 1)
    img, _, _ = render_frame(scn, RenderOptions(
        width=32, height=24, max_optic_depth=2, whitted=True, aa_diff=8,
        aa_depth=2), device="cpu")
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    assert (np.abs(img - bg).max(-1) < 1e-6).mean() > 0.98
    assert not [r for r in adaptive.history if r["kind"] == "whitted"]


def test_whitted_applies_to_stereo_modes():
    """-w composes with every stereo layout: each eye panel gets its own
    corner grid and refinement, and the frame agrees in the large with
    the point-sampled one."""
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    for mode in ("side", "over", "anaglyph"):
        img_w, _, _ = render_frame(adaptive_scene(True), RenderOptions(
            width=32, height=24, stereo=mode, whitted=True, aa_diff=8,
            aa_depth=2), device="cpu")
        img_p, _, _ = render_frame(adaptive_scene(True), RenderOptions(
            width=32, height=24, stereo=mode), device="cpu")
        assert np.isfinite(img_w).all(), mode
        assert img_w.shape == img_p.shape
        assert np.abs(img_w - img_p).mean() < 0.08, mode
        if mode == "anaglyph":
            assert (img_w[..., 1] == 0).all()


def test_adaptive_sampling_converges():
    """The jittered adaptive mean stays close to the deterministic
    one-sample frame."""
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    img, _, _ = render_frame(adaptive_scene(True), RenderOptions(
        width=24, height=18, samples=4, max_optic_depth=3), device="cpu")
    img0, _, _ = render_frame(adaptive_scene(True), RenderOptions(
        width=24, height=18, max_optic_depth=3), device="cpu")
    assert np.isfinite(img).all()
    assert np.abs(img - img0).mean() < 0.05


def test_adaptive_uses_more_samples_than_min():
    """Noisy edge pixels keep sampling past opts.samples: more rays than
    the plain average of the same number of samples."""
    from ndt_tpu_torch.render.engine import RenderOptions, render_frame

    kw = dict(width=16, height=12, samples=2, max_optic_depth=2)
    _, _, n_adaptive = render_frame(adaptive_scene(True),
                                    RenderOptions(adaptive=True, **kw),
                                    device="cpu")
    _, _, n_fixed = render_frame(adaptive_scene(True),
                                 RenderOptions(adaptive=False, **kw),
                                 device="cpu")
    assert n_adaptive > n_fixed
