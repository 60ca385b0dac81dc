"""kernel_ms: device milliseconds of the program's own CUDA kernels
(``portbench.profile.PROGRAM_KERNELS``, by name) per traced frame, from
the profiler.  Moves frame_device_ms;
as ``kernel_ms.frame_s``, frame_s."""


def read(data):
    p = data.profile
    if not p or not p["program_kernels"]:
        return None
    return 1e3 * sum(v["s"] for v in p["program_kernels"].values()) \
        / p["frames"]
