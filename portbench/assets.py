"""The configuration's scene through the program's asset path.

The scene generator named by the configuration (scenes/<generator>.py)
makes the triangles and textures from its arguments; they are exported as a
GLB (PNG textures), read back and written as a `.pt` file by the program's
tools, and the `.pt` is loaded onto the card by `load_device_scene`, as a
user loads a scene. The `.pt` is written once per checkout, at a fixed path
under portbench/cache/, and read by every later run of a cell on it.
"""

from __future__ import annotations

import pathlib
import tempfile
import time

import numpy as np

from . import cells

CACHE = cells.HERE / "cache"


def generate(config: dict):
    """The benchmark's own scene (scenes/*.py Scene): what the reference
    renders and what the asset path exports."""
    spec = config["scene"]
    return cells.load_module("scenes", spec["generator"]).make(**spec["args"])


def pt_path(config: dict) -> pathlib.Path:
    return CACHE / config["name"] / "scene.pt"


def write_pt(config: dict) -> pathlib.Path:
    """The configuration's `.pt`, written through the program's asset path
    unless it is there already."""
    from rayfinder_tpu_torch.io import PtScene, write_pt as program_write_pt
    from rayfinder_tpu_torch.scene.flatten import FlattenedScene
    from rayfinder_tpu_torch.scene.texture import Texture
    from rayfinder_tpu_torch.tools.export_glb import export_flattened_glb

    pt = pt_path(config)
    if pt.exists():
        return pt
    pt.parent.mkdir(parents=True, exist_ok=True)
    scene = generate(config)
    flat = FlattenedScene(positions=scene.positions, normals=scene.normals,
                          tex_coords=scene.tex_coords, texture_indices=scene.texture_indices)
    textures = [Texture(np.asarray(t.pixels, np.uint32), width=t.width, height=t.height)
                for t in scene.textures]
    with tempfile.TemporaryDirectory(dir=pt.parent) as tmp:
        glb = pathlib.Path(tmp) / "scene.glb"
        export_flattened_glb(flat, textures, glb)
        part = pathlib.Path(tmp) / "scene.pt"
        program_write_pt(PtScene.from_gltf(glb), part)
        part.replace(pt)
    return pt


def load(config: dict, device) -> tuple[object, dict]:
    """The program's DeviceScene on `device`, and {"pt_write_s": seconds
    to write the `.pt` (0 where it was there), "scene_load_s": seconds of
    load_device_scene, "triangles"}."""
    from rayfinder_tpu_torch.render.scene import load_device_scene

    t0 = time.perf_counter()
    written = not pt_path(config).exists()
    pt = write_pt(config)
    pt_write_s = time.perf_counter() - t0 if written else 0.0
    t0 = time.perf_counter()
    scene = load_device_scene(pt, device=device)
    if getattr(device, "type", str(device)) == "cuda":
        import torch

        torch.cuda.synchronize(device)
    return scene, {"pt_write_s": pt_write_s, "scene_load_s": time.perf_counter() - t0,
                   "triangles": int(scene.num_triangles)}
