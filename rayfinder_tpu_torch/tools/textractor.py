"""CLI: dump each base-color texture of a glTF scene to PNG.

Parity with the reference's textractor (src/textractor/main.cpp:16-63):
writes base_color_texture_<N>.png files (BGRA unpacked to RGBA), with the
port's zlib PNG writer (no Pillow needed).

    python -m rayfinder_tpu_torch.tools.textractor scene.glb --outdir textures/
"""

from __future__ import annotations

import argparse
import pathlib
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("gltf", type=pathlib.Path)
    parser.add_argument("--outdir", type=pathlib.Path, default=pathlib.Path("."))
    args = parser.parse_args(argv)

    from ..scene import load_gltf
    from ..utils.image import write_png

    scene = load_gltf(args.gltf)
    for i, tex in enumerate(scene.base_color_textures):
        out = args.outdir / f"base_color_texture_{i}.png"
        write_png(out, tex.to_rgba())
        print(f"wrote {out} ({tex.width}x{tex.height})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
