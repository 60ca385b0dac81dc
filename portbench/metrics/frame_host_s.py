"""frame_host_s: the traced window's host-clock seconds over its whole
frames, as frame_s reads an untraced window (the readers' spans on).  The
frame time of the cells whose host's speed drifts too far between runs to
bound it end to end.  Moves frame_device_ms."""


def read(data):
    if not data.frames or not data.window_s:
        return None
    return data.window_s / data.frames
