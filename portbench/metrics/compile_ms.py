"""compile_ms: host milliseconds a frame spends compiling its scene
(``compile_scene``) and uploading it (``to_device``), as render_frame
calls them, over the window's frames.  Moves frame_device_ms;
as ``compile_ms.frame_s``, frame_s."""

ENGINE = "ndt_tpu_torch.render.engine"
SPANS = {"compile": [(ENGINE, "compile_scene"), (ENGINE, "to_device")]}


def read(data):
    if not data.frames:
        return None
    return 1e3 * data.span_s["compile"] / data.frames
