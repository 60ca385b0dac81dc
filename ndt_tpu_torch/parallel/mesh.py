"""Pixel-split frames over several devices (counterpart of
``ndt_tpu/parallel/mesh.py``).

The JAX package shards a frame's flat ray batch over a 1-D device mesh
with ``shard_map``: each chip runs the unmodified single-device render on
its share, the scene is replicated, and the only collectives are the ray
count's sum and the framebuffer's gather.  Here a split is a tuple of
torch devices, its *places* (``make_pixel_mesh``; repeats are allowed, so
``("cuda:0", "cuda:0")`` splits a frame over one card and
``("cpu",) * 3`` over the CPU):

* the screen-blocked flat pixel grid (``engine._blocked_perm``) or a ray
  batch is cut into contiguous slices, one per place, each a whole number
  of RT-ray cull tiles (``slices``), so every cull tile holds the rays it
  holds in the frame on one device;
* each place renders its slice through the unmodified single-device path
  (``engine.render_xy``, ``engine.render_rays_chunked``) from a host
  thread of its own (torch's current device and stream are per thread),
  on the scene's copy on its device (``Split``: the counterpart of
  ``replicate``) and, on a card, on a stream of its own, so that two
  places on one card can overlap their host work;
* colour and depth come back to the host in order; ray counts are summed.

Random draws: jittered and aperture primary rays are drawn from the
frame's generator on the frame's device *before* the split, in the
single-device order (``engine.render_points``), so ``-n`` and ``-w``
frames keep their bits.  The draws inside the bounce loop (the area
lights' points, ``render/shade.py``) come from one generator per place,
on its device, seeded ``opts.seed + 1 + the place's index`` in the split.

In a multi-process run (``parallel/distributed.py``: torch.distributed
over gloo) the places are every process's local devices in rank order.
Each process renders its own places' slices, then all-gathers colour and
depth, so every process holds the frame, and all-reduces the ray count
(the image collect of ndt.c:1277-1309).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ndt_tpu_torch.camera import render_device
from ndt_tpu_torch.parallel import distributed
from ndt_tpu_torch.render.kernels import RT
from ndt_tpu_torch.scene.compile import to_device


def make_pixel_mesh(devices=None) -> tuple:
    """The places of a pixel split as torch devices: ``devices`` (repeats
    allowed), or every visible card in order.  A CUDA device without an
    index is the current one; a device that does not exist raises."""
    if devices is None:
        n = torch.cuda.device_count()
        if not n:
            raise RuntimeError("no CUDA device is visible: name the split's "
                               "devices (e.g. ('cpu',) * 3)")
        devices = [f"cuda:{i}" for i in range(n)]
    places = tuple(_place(d) for d in devices)
    if not places:
        raise ValueError("a pixel split needs at least one device")
    return places


def _place(device):
    d = render_device(device)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"unsupported device {d} (cpu or cuda)")
    index = torch.cuda.current_device() if d.index is None else d.index
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(f"no device {d}: {torch.cuda.device_count()} "
                         "visible")
    return torch.device("cuda", index)


def slices(n_items, n_places):
    """[(start, stop)] of each place's contiguous share of ``n_items``: a
    whole number of RT-ray cull tiles each (the last non-empty one ends at
    n_items), as even as whole tiles allow; places past the tiles get
    empty slices."""
    tiles = -(-n_items // RT)
    base, extra = divmod(tiles, n_places)
    out, start = [], 0
    for k in range(n_places):
        stop = min(n_items, start + (base + (k < extra)) * RT)
        out.append((start, stop))
        start = stop
    return out


def replicate(scn, devices):
    """The compiled scene ``scn`` (a DeviceScene) on each of ``devices``:
    one copy per device (the counterpart of the JAX package's replicate),
    ``scn`` itself where the device is its own."""
    copies = {scn.device: scn}
    for d in devices:
        if d not in copies:
            copies[d] = to_device(scn.host, d)
    return tuple(copies[d] for d in devices)


def camera_to(cam, device):
    """A CameraData's tensors on ``device``."""
    return dataclasses.replace(cam, **{
        f.name: getattr(cam, f.name).to(device)
        for f in dataclasses.fields(cam)
        if isinstance(getattr(cam, f.name), torch.Tensor)})


@functools.lru_cache(maxsize=None)
def _stream(device, j):
    """The stream of the j-th place on a card, the same for every frame:
    the caching allocator keeps its freed blocks per stream."""
    return torch.cuda.Stream(device)


@dataclasses.dataclass
class Place:
    """One place of a split: its device, the frame's scene there, its
    generator of the bounce loop's draws, and its stream (cards only)."""

    index: int                 # among this process's places
    device: torch.device
    scene: object              # DeviceScene on ``device``
    gen: torch.Generator
    stream: object = None


class Split:
    """A frame's pixel split over ``opts.devices``: this process's places,
    each with the compiled scene on its device (one copy per device; the
    frame's own where the devices agree) and its generator, and where they
    sit among every process's places.  Built once per frame
    (engine.render_frame): the generators' states carry over between the
    frame's eye panels, refinement levels and sampling rounds."""

    def __init__(self, scn, opts):
        local = make_pixel_mesh(opts.devices)
        counts = distributed.place_counts(len(local))
        self.first = sum(counts[:distributed.process_index()])
        self.counts = counts
        self.dtype = np.dtype(opts.dtype)
        self.places = [
            Place(k, d, sd, torch.Generator(device=d).manual_seed(
                opts.seed + 1 + self.first + k),
                _stream(d, local[:k].count(d)) if d.type == "cuda" else None)
            for k, (d, sd) in enumerate(zip(local, replicate(scn, local)))]

    def bounds(self, n_items):
        """[(start, stop)] of this process's places' slices of n_items."""
        return slices(n_items, sum(self.counts))[
            self.first:self.first + len(self.places)]

    def map(self, n_items, work):
        """Cut ``n_items`` into slices over every process's places and run
        ``work(place, start, stop)`` -> (colour [n, 3], depth [n] numpy,
        rays) for this process's places, each in a thread of its own.
        Returns colour and depth of all n_items in order and the rays of
        every place (gathered over the processes)."""
        mine = self.bounds(n_items)
        for pl in self.places:
            if pl.stream is not None:   # after what the caller enqueued
                pl.stream.wait_stream(torch.cuda.current_stream(pl.device))
        with ThreadPoolExecutor(len(self.places)) as ex:
            futures = [ex.submit(_run, pl, work, a, b)
                       for pl, (a, b) in zip(self.places, mine) if b > a]
            parts = [f.result() for f in futures]
        if parts:
            color = np.concatenate([p[0] for p in parts])
            depth = np.concatenate([p[1] for p in parts])
        else:
            color, depth = (np.zeros((0, 3), self.dtype),
                            np.zeros(0, self.dtype))
        rays = sum(p[2] for p in parts)
        if len(self.counts) == 1:
            return color, depth, rays
        bounds = slices(n_items, sum(self.counts))
        shares = [sum(b - a for a, b in bounds[s:s + n]) for s, n in zip(
            np.cumsum([0] + self.counts[:-1]), self.counts)]
        return distributed.gather_frame(color, depth, rays, shares)


def _run(pl: Place, work, a, b):
    with contextlib.ExitStack() as stack:
        if pl.stream is not None:
            stack.enter_context(torch.cuda.device(pl.device))
            stack.enter_context(torch.cuda.stream(pl.stream))
        return work(pl, a, b)


def render_grid_sharded(split: Split, cam, x, y, opts, eye="center",
                        gen=None):
    """Render a flat pixel grid split over the places: (colour [P, 3],
    depth [P] numpy, rays).  ``x, y``: [P] numpy screen coordinates in
    screen-blocked order, padded as engine._render_grid pads them for one
    device.  With one sample each place makes its slice's primary rays
    from its copy of ``cam``; with opts.samples > 1 (the plain average,
    opts.adaptive off) each sample's rays of each batch are drawn from
    ``gen`` on cam's device, in the single-device order, then split."""
    from ndt_tpu_torch.render.engine import (_TILE, frame_generator,
                                             gen_rays, render_xy)

    if opts.samples == 1:
        cams = {pl.device: camera_to(cam, pl.device) for pl in split.places}

        def work(pl, a, b):
            return render_xy(pl.scene, cams[pl.device], x[a:b], y[a:b],
                             opts, eye, pl.gen, _TILE)

        return split.map(len(x), work)
    tile = min(_TILE, len(x))
    dev = cam.pos.device
    if gen is None:
        gen = frame_generator(dev, opts)
    colors, depths, rays = [], [], 0
    for t0 in range(0, len(x), tile):
        xt = torch.as_tensor(x[t0:t0 + tile], device=dev)
        yt = torch.as_tensor(y[t0:t0 + tile], device=dev)
        csum = dsum = None
        for _ in range(opts.samples):
            o, v = gen_rays(cam, xt, yt, eye, (opts.width, opts.height),
                            True, gen)
            c, d, n = render_rays_sharded(split, o, v, opts)
            csum = c if csum is None else csum + c
            dsum = d if dsum is None else dsum + d
            rays += n
        colors.append(csum / opts.samples)
        depths.append(dsum / opts.samples)
    return np.concatenate(colors), np.concatenate(depths), rays


def shard_rays(split: Split, *arrays):
    """This process's places' slices (Split.bounds: whole 4096-ray tiles)
    of the [R, ...] ``arrays``, each on its place's device: one tuple per
    place (the counterpart of the JAX package's shard_rays)."""
    return [tuple(x[a:b].to(pl.device) for x in arrays)
            for pl, (a, b) in zip(split.places,
                                  split.bounds(arrays[0].shape[0]))]


def render_rays_sharded(split: Split, o, v, opts):
    """Render a batch of primary rays ``o, v`` ([R, D] on one device)
    split over the places, each place's slice in batches of at most
    engine._TILE rays: (colour [R, 3], depth [R] numpy, rays).  The
    refinement levels and the adaptive rounds render through it."""
    from ndt_tpu_torch.render.engine import _TILE, render_rays_chunked

    shards = shard_rays(split, o, v)

    def work(pl, a, b):
        so, sv = shards[pl.index]
        colors, depths, rays = [], [], 0
        for t0 in range(0, b - a, _TILE):
            c, d, n = render_rays_chunked(pl.scene, so[t0:t0 + _TILE],
                                          sv[t0:t0 + _TILE], opts, pl.gen)
            colors.append(c.cpu().numpy())
            depths.append(d.cpu().numpy())
            rays += int(n)
        return np.concatenate(colors), np.concatenate(depths), rays

    return split.map(o.shape[0], work)
