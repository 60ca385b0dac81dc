"""dense_ms_f64: host milliseconds a float64 frame spends in the dense
trace (``_dense_call``, every trace of the frame's rays), over the
window's frames.  Moves frame_s_f64."""

SPANS = {"dense": [("ndt_tpu_torch.render.trace", "_dense_call")]}


def read(data):
    if not data.frames or not data.span_s["dense"]:
        return None
    return 1e3 * data.span_s["dense"] / data.frames
