"""The bench courtyard through the production asset path.

`courtyard_scene(scale, textured)` -> GLB (tools/export_glb.py, textures as
PNGs) -> `PtScene.from_gltf` -> `write_pt` -> `read_pt` -> `load_device_scene`,
as the JAX bench builds its scene (bench.py _courtyard_pt_scene), without its
fallback: a failure raises. The `.pt` file is cached under
`rayfinder_tpu_torch/_build/` as `courtyard_s{scale}_tex{0|1}.pt`, so the
export and the BVH build happen once and never inside a timed window.
"""

from __future__ import annotations

import pathlib
import tempfile
import time

from ..io import PtScene, write_pt
from ..render.scene import DeviceScene, load_device_scene
from ..scene.procedural import courtyard_scene
from ..tools.export_glb import export_flattened_glb

CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"

# The JAX bench's camera and sky (bench.py main_courtyard).
BENCH_CAMERA = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0)
BENCH_SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)


def courtyard_pt_scene(scale: int = 26, device="cuda",
                       textured: bool = False) -> tuple[DeviceScene, dict]:
    """courtyard_scene(scale, textured=textured) loaded from its `.pt` file
    (written on first use) onto `device`, and {"path", "bytes",
    "prepare_s", "load_s"}: the seconds to export and write the `.pt` (about
    0 when cached) and to load it."""
    t0 = time.perf_counter()
    pt = CACHE_DIR / f"courtyard_s{scale}_tex{int(textured)}.pt"
    if not pt.exists():
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        flat, textures = courtyard_scene(scale, textured=textured)
        with tempfile.TemporaryDirectory(dir=CACHE_DIR) as tmp:
            glb = pathlib.Path(tmp) / "courtyard.glb"
            export_flattened_glb(flat, textures, glb)
            part = pathlib.Path(tmp) / pt.name
            write_pt(PtScene.from_gltf(glb), part)
            part.replace(pt)
    t1 = time.perf_counter()
    scene = load_device_scene(pt, device=device)
    t2 = time.perf_counter()
    return scene, dict(path=str(pt), bytes=pt.stat().st_size, prepare_s=t1 - t0,
                       load_s=t2 - t1)
