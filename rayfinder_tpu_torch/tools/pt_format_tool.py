"""CLI: convert a glTF/GLB scene into a `.pt` file.

Parity with the reference's pt-format-tool (src/pt-format-tool/main.cpp:15-35):
`python -m rayfinder_tpu_torch.tools.pt_format_tool <file.glb>` writes a
sibling `<file>.pt` with the prebuilt BVH (the port's `io/` and `scene/`
copies: the same bytes as `rayfinder_tpu.tools.pt_format_tool`).
"""

from __future__ import annotations

import argparse
import pathlib
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("gltf", type=pathlib.Path, help="input .glb/.gltf file")
    parser.add_argument(
        "-o", "--output", type=pathlib.Path, default=None, help="output .pt path"
    )
    args = parser.parse_args(argv)

    from ..io import PtScene, write_pt

    out = args.output or args.gltf.with_suffix(".pt")
    scene = PtScene.from_gltf(args.gltf)
    write_pt(scene, out)
    print(f"wrote {out} ({out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
