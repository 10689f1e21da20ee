"""Seconds of the program's scene load at set-up (io/ptformat.py read_pt and
render/scene.py load_device_scene: read, cluster tables, upload), on the
host's clock around the call, synchronised."""


def read(run):
    return run.spans.get("scene_load_s")
