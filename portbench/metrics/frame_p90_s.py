"""frame_p90_s: the 90th percentile of the host-clock time of the
window's frames (s), each frame from the call of render_frame to its
image.  Moves frame_device_ms."""

import numpy as np


def read(data):
    if not data.latencies:
        return None
    return float(np.percentile(data.latencies, 90))
