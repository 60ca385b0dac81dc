"""device_idle_pct: the share of the traced frames' span in which the
card ran no kernel, copy or memset (the union of their intervals, from
the profiler), in %.  Moves frame_device_ms;
as ``device_idle_pct.frame_s``, frame_s."""


def read(data):
    p = data.profile
    if not p or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
