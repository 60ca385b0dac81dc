"""device_idle_pct_f64: device_idle_pct of the float64 frames.  Moves
frame_s_f64."""

from portbench.metrics.device_idle_pct import read  # noqa: F401
