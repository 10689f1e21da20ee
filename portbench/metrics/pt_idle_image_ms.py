"""Device idle ms per batch inside the program's span rf.pt.image
(render/renderer.py Renderer.image_u8) and its children rf.pt.unswizzle,
rf.pt.display and rf.pt.readback, over the traced window's idle intervals
(portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.idle_ms_per_frame(run, ("rf.pt.image",), self_time=False)
