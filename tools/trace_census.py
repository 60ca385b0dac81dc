#!/usr/bin/env python3
"""The trace census of registry frames on one CUDA card: every trace
launch of a frame, re-run alone, with this checkout's choice of walk
beside both walks forced and beside other checkouts' kernels.

    python3 tools/trace_census.py [--baseline TREE ...] [--frames KEY ...]
                                  [--size WxH ...] [--branch fused unfused]
                                  [--modes NAME ...] [--tail | --no-tail]
                                  [--log FILE]

For each frame (FRAMES; all by default), size (640x480 and 160x120 by
default) and branch (fused: trace_closest; unfused: trace, trace_any and
trace_shadow), the launches of the wrappers ``--modes`` (all three by
default): one warm-up frame, then one frame whose trace launches are
captured where render/trace.py calls the wrappers, then each launch
re-run alone.  Each launch's device time (CUDA events, queue pre-filled)
is measured for this checkout's walk (``this``: kernels.trace_tail_slots
and kernels.any_warp_cull), for every launch without a live mask walked
slot by slot (``tail``) and by the other walks (``other``: one thread a
ray, or groups of G) unless ``--no-tail``, in a frame with any-mode
launches with the any walk's warp cull forced on and off on each such
launch without a live mask (``cull on``, ``cull off``), and for each
``--baseline`` tree's kernels (another checkout, e.g. a ``git archive``
of the parent commit, built as chip_smoke.py builds it), in turns
(other, this, this, other).  Every output of every launch is held to the
twin's and to each other's to the bit (with the early exit, on the live
lanes).  Per frame it prints the summed trace ms of each and by mode;
the per-launch lines go to ``--log``.  Prints the card's name and power
limit first; exits nonzero if a launch disagrees.
"""

import argparse
import collections
import os
import sys
import time
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# key -> chip_smoke.scene arguments: every scene of the registry (YAML
# scenes aside: the card's machine has no PyYAML)
FRAMES = {
    "balls": ("balls", 4, 0, 1500),
    "anim6d": ("anim6d", 6, 1, 4),
    "lights3d": ("lights3d", 3),
    "test": ("test", 4),
    "test3": ("test", 3),
    "infinite4d": ("infinite4d", 4),
    "empty": ("empty", 4),
    "hypercube": ("hypercube", 4, 10, 2400),
    "hcube": ("hypercube", 4, 0, 2400, "hcube"),
    "walls": ("hypercube", 4, 10, 2400, "walls"),
    "points": ("hypercube-points", 6, 0, None),
    "nelder-mead": ("nelder-mead", 3, 12, None),
    "cluster5d": ("cluster5d", 5),
    "random20": ("random", 5, 0, 1, "20"),
    "random150": ("random", 5, 0, 1, "150"),
    "random600": ("random", 5, 0, 1, "600"),
}
NAMES = ("trace_closest", "trace_any", "trace_shadow")


def frame_census(torch, K, C, scn, opts, label, others, log, names=NAMES):
    """The census of one frame's launches of the wrappers ``names``: (ok,
    {label: summed ms}, {mode: {label: summed ms}})."""
    import contextlib

    from ndt_tpu_torch.render import engine
    from ndt_tpu_torch.render import trace as T

    C.quiet(engine.render_frame, scn, opts)
    with contextlib.ExitStack() as st:
        caps = {n: st.enter_context(C.captured(T, n)) for n in names}
        C.quiet(engine.render_frame, scn, opts)
    torch.cuda.synchronize()
    calls = [(n, a) for n in names for a, _ in caps[n]]
    print(f"{label}: launches " + ", ".join(
        f"{n} {len(caps[n])}" for n in names), file=log)
    if not calls:
        return True, {}, {}
    if not caps.get("trace_any"):
        others = [b for b in others if not isinstance(b, C.AnyCull)]
    fns = [(lambda n=n, a=a: getattr(K, n)(*a)) for n, a in calls]
    times = C.time_launches(K, fns, others)
    ok = True
    by_mode = collections.defaultdict(collections.Counter)
    for i, (name, args) in enumerate(calls):
        sd, o = args[0], args[1]
        R = o.shape[0]
        live = args[7] if len(args) > 7 else None
        mine = getattr(K, name)(*args)
        outs = {"twin": getattr(K, name + "_ref")(*args)}
        for b in others:
            with b.active(K):
                outs[b.name] = getattr(K, name)(*args)
        bad = {k: C.bits_equal(mine, x, live) for k, x in outs.items()}
        ok &= not any(bad.values())
        for lb, ms in times:
            by_mode[name][lb] += ms[i]
        print(f"{label} {name} #{i}: R={R}, live "
              f"{'-' if live is None else int(live.sum())}, lists max "
              f"{int(args[5].sum(1).max())}, slots "
              f"{K.trace_tail_slots(sd, R, live)}, cull "
              f"{name == 'trace_any' and K.any_warp_cull(sd, R, live)}"
              f", G "
              f"{K.walk_group(R, None, K.group_cap(sd))}; "
              + "; ".join(f"{lb} {ms[i]:.4f} ms" for lb, ms in times)
              + "; lanes differing: " + ", ".join(
                  f"{k} {n}" for k, n in bad.items()), file=log)
    totals = collections.Counter()
    for mode in by_mode.values():
        totals.update(mode)
    return ok, totals, by_mode


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="TREE", action="append",
                    default=[], help="another checkout timed beside this one")
    ap.add_argument("--frames", nargs="+", choices=sorted(FRAMES),
                    default=list(FRAMES))
    ap.add_argument("--size", metavar="WxH", nargs="+",
                    default=["640x480", "160x120"])
    ap.add_argument("--branch", nargs="+", choices=("fused", "unfused"),
                    default=["fused", "unfused"])
    ap.add_argument("--modes", nargs="+", choices=NAMES, default=list(NAMES),
                    help="the wrappers whose launches are timed")
    ap.add_argument("--tail", action=argparse.BooleanOptionalAction,
                    default=True, help="time the slot walk forced on and off")
    ap.add_argument("--log", default=os.devnull,
                    help="file for the per-launch lines (none by default)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_census: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as C
    from ndt_tpu_torch.kernels import build
    from ndt_tpu_torch.render import kernels as K
    from ndt_tpu_torch.render.engine import RenderOptions

    warnings.simplefilter("ignore", RuntimeWarning)   # dense scenes' gates
    print(C.card_line())
    baselines = [C.Baseline(tree) for tree in args.baseline]
    build.build()
    build.load_library()
    for b in baselines:
        b.load()
    others = (baselines
              + ([C.TracePath(False), C.TracePath(True)] if args.tail
                 else [])
              + [C.AnyCull(False), C.AnyCull(True)])
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    ok = True
    with open(args.log, "w") as log:
        for size in args.size:
            w, h = (int(x) for x in size.split("x"))
            for key in args.frames:
                for br in args.branch:
                    t0 = time.perf_counter()
                    label = f"{key} {w}x{h} {br}"
                    with C.branch(br == "fused"):
                        fok, totals, by_mode = frame_census(
                            torch, K, C, C.quiet(C.scene, *FRAMES[key]),
                            RenderOptions(width=w, height=h), label, others,
                            log, args.modes)
                    log.flush()
                    ok &= fok
                    modes = "; ".join(
                        f"{n}: " + ", ".join(f"{lb} {ms:.4f}" for lb, ms
                                             in by_mode[n].items())
                        for n in by_mode)
                    print(f"[trace census] {label}: summed ms "
                          + ", ".join(f"{lb} {ms:.4f}"
                                      for lb, ms in totals.items())
                          + f" ({modes}); bits {'equal' if fok else 'DIFFER'}"
                          f"; {time.perf_counter() - t0:.1f} s", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
