#!/usr/bin/env python3
"""The shade census of registry frames on one CUDA card: every shade
launch of a fused frame, re-run alone, with this checkout's choice of path
beside both paths forced and beside other checkouts' kernels.

    python3 tools/shade_census.py [--baseline TREE ...] [--frames KEY ...]
                                  [--size WxH ...]

For each frame (FRAMES, at its own size or at each ``--size``; all by
default): one warm-up frame, then one frame whose shade launches are
captured where render/trace.py calls the wrappers, then
chip_smoke.shade_census over them.  Each launch's device
time alone (CUDA events, queue pre-filled) is printed for this checkout's
path (``this``: kernels.shade_grouped), for every launch of at most
FILL / 2 rays walked one thread a pair in the ray's block (``block``) and
by groups over the whole launch (``grouped``), and for each ``--baseline``
tree's kernels (another checkout, e.g. a ``git archive`` of the parent
commit, built as chip_smoke.py builds it), in turns (other, this, this,
other); every output of every launch equal to the twin's and to each
other's to the bit; and for each launch this checkout walks by groups, its
three kernels' device times (torch.profiler).  Prints the card's name and
power limit first; exits nonzero if a launch disagrees.
"""

import argparse
import os
import sys
import time
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# key -> (chip_smoke.scene arguments, width, height): the registry scenes
# whose largest family holds a warp's worth of leaves (kernels.group_cap
# >= 32: the grouped path's scenes), and anim6d and the test scene (fewer)
FRAMES = {
    "balls": (("balls", 4, 0, 1500), 1920, 1080),
    "hypercube": (("hypercube", 4, 10, 2400), 640, 480),
    "walls": (("hypercube", 4, 10, 2400, "walls"), 640, 480),
    "cluster5d": (("cluster5d", 5), 640, 480),
    "random20": (("random", 5, 0, 1, "20"), 640, 480),
    "random150": (("random", 5, 0, 1, "150"), 640, 480),
    "random600": (("random", 5, 0, 1, "600"), 640, 480),
    "points": (("hypercube-points", 6, 0, None), 640, 480),
    "nelder-mead": (("nelder-mead", 3, 12, None), 640, 480),
    "anim6d": (("anim6d", 6, 1, 4), 640, 480),
    "test": (("test", 4), 640, 480),
}


# the kernels of a launch walked by groups (csrc/shade.cu ndt_shade)
PARTS = ("compact_pairs", "walk_pairs", "shade_kernel")


def kernel_split(torch, K, C, label, sizes, reps=10):
    """Per launch this checkout walks by groups: the device time of each of
    its kernels (PARTS), the mean over ``reps`` launches under
    torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    for i, (mode, R, a, k) in enumerate(sizes):
        if not K.shade_grouped(a[0], R):
            continue
        kw = {"area": k["area"]} if k.get("area") is not None else {}
        fn = C.shade_launch(K, mode, a[:11],
                            a[11:15] if mode != "local" else None, kw)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split = dict.fromkeys(PARTS, 0.0)
        for e in prof.key_averages():
            us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0))
            for part in PARTS:
                if part in e.key:
                    split[part] += us / 1e3 / reps
        print(f"[shade split] {label} #{i} {mode}: R={R}, "
              + ", ".join(f"{p} {ms:.4f} ms" for p, ms in split.items())
              + f" (mean of {reps}, torch.profiler)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="TREE", action="append",
                    default=[], help="another checkout timed beside this one")
    ap.add_argument("--frames", nargs="+", choices=sorted(FRAMES),
                    default=list(FRAMES))
    ap.add_argument("--size", metavar="WxH", nargs="+", default=[None],
                    help="render every frame at these sizes (e.g. 160x120: "
                    "a primary launch of 19200 rays, walked by groups)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("shade_census: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as C
    from ndt_tpu_torch.kernels import build
    from ndt_tpu_torch.render import engine
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.render.engine import RenderOptions

    warnings.simplefilter("ignore", RuntimeWarning)   # dense scenes' gates
    print(C.card_line())
    baselines = [C.Baseline(tree) for tree in args.baseline]
    build.build()
    build.load_library()
    for b in baselines:
        b.load()
    others = baselines + [C.ShadePath(False), C.ShadePath(True)]
    ok = True
    for size, key in ((z, k) for z in args.size for k in args.frames):
        t0 = time.perf_counter()
        scene_args, w, h = FRAMES[key]
        if size:
            w, h = (int(x) for x in size.split("x"))
        scn = C.quiet(C.scene, *scene_args)
        opts = RenderOptions(width=w, height=h)
        C.quiet(engine.render_frame, scn, opts)
        with C.shade_launch_sizes() as sizes:
            C.quiet(engine.render_frame, scn, opts)
        torch.cuda.synchronize()
        label = f"{key} {w}x{h}"
        C.print_launch_sizes(label, sizes)
        ok &= C.shade_census(torch, K, label, sizes, others)
        kernel_split(torch, K, C, label, sizes)
        print(f"[shade census] {label}: {time.perf_counter() - t0:.1f} s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
