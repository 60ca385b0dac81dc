"""stack_ms: host milliseconds a frame spends in the refraction stack
loop (``_run_stack``, nested calls counted once), over the window's
frames; nothing where the window never entered it.  Moves frame_s."""

SPANS = {"stack": [("ndt_tpu_torch.render.engine", "_run_stack")]}


def read(data):
    if not data.frames or not data.span_s["stack"]:
        return None
    return 1e3 * data.span_s["stack"] / data.frames
