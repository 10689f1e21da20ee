"""The full-scale quality gate's witness on the CPU: the JAX package's own
render against its golden, beside the port's render from the card.

    JAX_PLATFORMS=cpu python tests/torch_quality_witness.py \
        [--port chiprun_out/quality_courtyard_port.npz] [--jax-image PATH.npy] \
        [--mask PATH.npy]

Renders tools/make_quality_goldens.py quality_image(*courtyard_config(),
engine="reference") with JAX on the CPU (512x512, 32 spp, 4 bounces; about
7 minutes on 8 cores, under 1 GiB) and holds it to
tests/goldens/quality_courtyard_512x512_32spp.npz (baked on a TPU by the
wavefront engine) with the port's gate, rayfinder_tpu_torch/tools/
make_quality_goldens.py quality_gate: the RMSE over every pixel, off and on
the pixels whose middle ray first hits a face on a texel edge (the
courtyard's +x wall, u = 8.0; texel_wrap_pixels, by brute force on the
CPU, about 11 minutes), and the mean difference there. The JAX render's
RMSE on those pixels is the gate's WRAP_RMSE_JAX_CPU.

With --port (the images chip_smoke.py phase 12 writes on the card), the
same for each of the port's images, and each against JAX on the CPU.
--jax-image and --mask reuse the JAX render and the pixel mask saved
there, or save them there. Not a test: it imports JAX and the port, as the
tests do. The last line is a JSON object of every number.
"""

import argparse
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from rayfinder_tpu_torch.tools import make_quality_goldens as port_tool  # noqa: E402

GOLDEN = ROOT / "tests" / "goldens" / "quality_courtyard_512x512_32spp.npz"


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_make_quality_goldens", ROOT / "tools" / "make_quality_goldens.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _saved(path, make):
    """np.load(path) if it exists, else make() (saved to path if given)."""
    if path is not None and path.exists():
        return np.load(path), None
    t0 = time.perf_counter()
    out = make()
    if path is not None:
        np.save(path, out)
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=pathlib.Path, default=None,
                    help="npz of the port's 512x512 images (chip_smoke.py phase 12)")
    ap.add_argument("--jax-image", type=pathlib.Path, default=None,
                    help=".npy: reuse the JAX render saved there, or save it there")
    ap.add_argument("--mask", type=pathlib.Path, default=None,
                    help=".npy: reuse the texel-edge pixel mask saved there, or save it there")
    args = ap.parse_args(argv)

    tool = _jax_tool()
    scene, sky, camera, kw = tool.courtyard_config()
    jax_img, jax_secs = _saved(args.jax_image, lambda: tool.quality_image(
        scene, sky, camera, engine="reference", **kw))

    def mask():
        p_scene, _, p_camera, p_kw = port_tool.courtyard_config("cpu")
        return port_tool.texel_wrap_pixels(p_scene, p_camera, p_kw["width"], p_kw["height"])

    wrap, mask_secs = _saved(args.mask, mask)
    out = {"jax_cpu_seconds": jax_secs, "mask_seconds": mask_secs,
           "jax_cpu_vs_golden": port_tool.quality_gate(jax_img, GOLDEN, wrap)}
    if args.port is not None:
        jax_file = args.port.with_name("jax_cpu_image.npz")
        np.savez(jax_file, image=jax_img)
        with np.load(args.port) as data:
            for name in data.files:
                out[f"port_{name}_vs_golden"] = port_tool.quality_gate(data[name], GOLDEN, wrap)
                out[f"port_{name}_vs_jax_cpu"] = port_tool.quality_gate(data[name], jax_file,
                                                                        wrap)
    for key, r in out.items():
        if isinstance(r, dict):
            print(f"{key}: RMSE {r['quality_rmse']:.7f}; on the {r['wrap_pixels']} texel-edge "
                  f"pixels {r['quality_rmse_wrap']:.7f} (mean difference "
                  f"{r['wrap_mean_diff']}, standard error {r['wrap_mean_se']}), off them "
                  f"{r['quality_rmse_off_wrap']:.7f}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
