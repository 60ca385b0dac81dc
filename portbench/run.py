#!/usr/bin/env python3
"""Run one cell of the benchmark of ``ndt_tpu_torch`` once, on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up (from the start of this process): the CUDA context, the program's
kernel library built or loaded, the cell's frames made from the seed and
built as the program's host scenes, the warm-up frames.  Then the window
renders frames back to back for ``--seconds`` (it closes at the end of its
last whole frame).  ``--trace 1`` wraps the program's functions in host
spans through the window and profiles a few more frames; its metrics are
the cell's per-layer ones, else its end-to-end ones.  After the window a
sample of its frames, drawn from the seed, is rendered again by the plain
reference (``portbench/reference``) and compared.

Prints, as its last line of standard output, one JSON object: correct,
attempted (frames), failed (compared frames over the limit), metrics,
device (and with --trace 1 a breakdown), and last "checks", each compared
number beside its limit; the same checks are the last lines of standard
error.  Exits 2 without a result when no CUDA card (or fewer than the
cell asks for) is visible, when a module of JAX or of the JAX package is
loaded once the window has closed, or when a file the cell names is
missing.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# host threads of the process: the program's host work is one Python
# thread driving the card, so pools of CPU threads only contend with it
THREADS = 1


def _environment():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own kernel library goes to ndt_tpu_torch/_build), and
    the CPU thread pools of OpenMP and BLAS cut to ``THREADS``, before
    numpy or torch load."""
    base = os.path.join(ROOT, "portbench", ".cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed: a whole number >= 0")
    _environment()
    sys.path.insert(0, ROOT)

    from portbench import harness

    cell = harness.resolve(args.workload)
    import torch

    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(THREADS)

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = harness.run_cell(cell, args.seed, args.seconds,
                                      bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules loaded after the window: {bad}",
              file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
