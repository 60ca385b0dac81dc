"""kernels_roofline: the program's kernels' share of their roofline
(%) over the traced frames: the summed least time of their entry-point
calls (``portbench.bounds``: bytes over the card's bandwidth) over the
summed device time of their kernels from the profiler.  Nothing is read
where the profiler saw fewer walk kernels than there were entry-point
calls (dropped events would leave time out).  Moves frame_device_ms;
as ``kernels_roofline.frame_s``, frame_s."""

from portbench import bounds
from portbench.profile import WALK_KERNELS


def read(data):
    p = data.profile
    if not p or not data.launches or not p["program_kernels"]:
        return None
    walks = sum(v["n"] for k, v in p["program_kernels"].items()
                if k in WALK_KERNELS)
    if walks < len(data.launches):
        return None
    bw = bounds.bandwidth(data.card.split(",")[0].strip())
    bound_s = sum(bounds.launch_bytes(c) for c in data.launches) / bw
    kernel_s = sum(v["s"] for v in p["program_kernels"].values())
    return 100.0 * bound_s / kernel_s
