"""cull_ms: host milliseconds a frame spends in the fused step's culls
(``cull_lists`` and ``_shadow_culls``, nested calls counted once), over
the window's frames.  Moves frame_device_ms;
as ``cull_ms.frame_s``, frame_s."""

TRACE = "ndt_tpu_torch.render.trace"
SPANS = {"cull": [(TRACE, "cull_lists"), (TRACE, "_shadow_culls")]}


def read(data):
    if not data.frames or not data.span_s["cull"]:
        return None
    return 1e3 * data.span_s["cull"] / data.frames
