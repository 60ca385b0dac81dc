"""launches_per_frame: the CUDA kernels the profiler saw run in the
traced frames, over those frames: the host's enqueue count of a frame.
Moves frame_device_ms;
as ``launches_per_frame.frame_s``, frame_s."""


def read(data):
    p = data.profile
    if not p or not p["frames"] or not p["kernels"]:
        return None
    return p["kernels"] / p["frames"]
