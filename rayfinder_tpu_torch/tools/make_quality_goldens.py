"""The showcase-scale quality gate: its render, configuration and test.

Counterpart of `tools/make_quality_goldens.py` (`quality_image`,
`courtyard_config`). The goldens under tests/goldens/ were baked by the JAX
package's wavefront engine on a TPU; the port is held against them and
never writes them, so this module has no `main`. The Duck configuration
needs an asset that is not in the repository and is not here either.

The image: the tonemapped mean of two `num_frames` dispatches (frames 0 ..
2 num_frames - 1, spp 256 for the R2 period), kept in the accumulator's
block-major pixel order (render/tiling.py) reshaped to (height, width, 3),
as the JAX package's is and the golden was stored: both sides share the
order, so the RMSE is the row-major image's. Identical sample sequences,
so the engines agree to accumulation-order ulps; the golden's float16
quantization adds ~1.4e-4 RMSE.

The test (quality_gate). The JAX package's gate is quality_rmse, the RMSE
over every pixel, < QUALITY_RMSE_BUDGET, and runs only on the TPU. One
part of the courtyard is not reproducible off that platform: a face whose
three vertices share a texture coordinate c that lies on a texel edge
(texel_wrap_triangles; the textured courtyard's +x wall, u = 8.0). The
interpolated coordinate b0 c + b1 c + b2 c is c (1 + a few ulps of the
barycentrics' sum), so each hit reads the texel on one side of the edge or
the other by the last bits of b1 and b2, which the TPU that baked the
golden, a CPU and the card round differently. The golden's wall pixels are
a per-hit mix of the two columns that no other platform repeats (JAX's own
quality_image on the CPU misses the budget there as the port does, and the
two mixes agree in the mean). So the gate splits the
image by the first hit of each pixel's middle ray (texel_wrap_pixels, by
brute force, not by the walk under test):
- off those pixels, the budget as it is: RMSE < QUALITY_RMSE_BUDGET;
- on them, the texel mix agrees in the mean: per channel, the mean of
  image - golden lies within WRAP_MEAN_SIGMAS standard errors of 0 (a
  render reading one column on every hit moves it by tens of them);
- and on them the image is no farther from the golden than the JAX
  package's own render on the CPU: RMSE <= WRAP_RMSE_JAX_CPU.
quality_rmse over every pixel is reported beside these, always.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..prof.scenes import BENCH_CAMERA, BENCH_SKY
from ..render.camera import create_camera, primary_ray
from ..render.intersect import T_MAX, brute_force_closest_hit
from ..render.pathtracer import accumulate_samples_regen
from ..render.rng import blue_noise_tile
from ..render.scene import build_device_scene
from ..render.tiling import block_order_on, pixel_centres
from ..render.tonemap import tonemap
from ..scene.procedural import courtyard_scene
from ..sky.model import sky_state_from_ui

GOLDEN_DIR = pathlib.Path(__file__).resolve().parents[2] / "tests" / "goldens"
QUALITY_RMSE_BUDGET = 1e-3  # bench.py _QUALITY_RMSE_BUDGET
EXPOSURE = 0.25
# On the texel-edge pixels: the mean of image - golden within this many
# standard errors of 0, and the RMSE at most the JAX package's own render's
# there: tools/make_quality_goldens.py quality_image(engine="reference") on
# an x86-64 CPU against the courtyard golden (tests/torch_quality_witness.py).
WRAP_MEAN_SIGMAS = 4.0
WRAP_RMSE_JAX_CPU = 0.0077374


def golden_path(name: str, width: int, height: int, samples: int) -> pathlib.Path:
    return GOLDEN_DIR / f"quality_{name}_{width}x{height}_{samples}spp.npz"


def mean_image(accum, samples: int, width: int, height: int,
               exposure: float = EXPOSURE) -> np.ndarray:
    """tonemap(accum / samples, exposure) as an (height, width, 3) f32 array,
    in the accumulator's pixel order."""
    img = tonemap(accum / float(samples), exposure)
    return img.reshape(height, width, 3).cpu().numpy().astype(np.float32)


def load_golden(path, shape) -> np.ndarray:
    """The golden npz's f16 "image" as f32; raises if it is missing or not
    of the image's shape."""
    with np.load(path) as data:
        golden = data["image"].astype(np.float32)
    if golden.shape != tuple(shape):
        raise ValueError(f"golden {path} is {golden.shape}, the image {tuple(shape)}")
    return golden


def texel_wrap_triangles(scene) -> torch.Tensor:
    """(T,) bool on the scene's device: faces whose three vertices share a
    texture coordinate c (u or v), c != 0, on a texel edge of a texture more
    than one texel across (fract(c) x its size is a whole number). Which
    texel a hit on them reads is the last ulp of its barycentrics (module
    docstring); c = 0 interpolates to 0 exactly."""
    uv = scene.tri_uvs.double()
    tex = scene.tri_texture.long()
    size = torch.stack([scene.tex_width, scene.tex_height], 1).double()[tex]
    c = uv[:, 0]
    shared = (uv == c[:, None]).all(dim=1)
    edge = (c - torch.floor(c)) * size
    return (shared & (c != 0) & (edge == torch.round(edge)) & (size > 1)).any(dim=1)


def texel_wrap_pixels(scene, camera, width: int, height: int) -> np.ndarray:
    """(height, width) bool in the image's pixel order: the pixel's middle
    ray (sample noise 0.5) first hits a texel_wrap_triangles face, by
    brute_force_closest_hit (only rays that hit such a face at all are
    tested against every triangle)."""
    dev = scene.device
    wrap = texel_wrap_triangles(scene)
    ys, xs, _ = block_order_on(width, height, dev)
    u, v_tex = pixel_centres(ys, xs, width, height)
    noise = torch.full((u.shape[0], 2), 0.5, device=dev)
    inv_dims = (float(np.float32(1.0) / np.float32(width)),
                float(np.float32(1.0) / np.float32(height)))
    origin, direction = primary_ray(camera, u, v_tex, noise, inv_dims)
    out = torch.zeros(u.shape[0], dtype=torch.bool, device=dev)
    if bool(wrap.any()):
        near, _, _ = brute_force_closest_hit(origin, direction, scene.tri_positions[wrap],
                                             T_MAX)
        rays = torch.nonzero(near)[:, 0]
        hit, _, tri = brute_force_closest_hit(origin[rays], direction[rays],
                                              scene.tri_positions, T_MAX)
        out[rays] = hit & wrap[tri.long().clamp(min=0)]
    return out.reshape(height, width).cpu().numpy()


def quality_gate(img: np.ndarray, golden_file, wrap: np.ndarray) -> dict:
    """The gate of img against the golden (module docstring), wrap the
    texel_wrap_pixels mask. Returns quality_rmse (every pixel),
    quality_rmse_off_wrap, wrap_pixels, quality_rmse_wrap, wrap_mean_diff
    and wrap_mean_se (per channel; the mean is tested from two pixels on),
    and quality_ok."""
    diff = img - load_golden(golden_file, img.shape)
    on = diff[wrap].astype(np.float64)
    n = on.shape[0]
    line = {
        "quality_rmse": float(np.sqrt(np.mean(diff ** 2))),
        "quality_rmse_off_wrap": float(np.sqrt(np.mean(diff[~wrap] ** 2))),
        "wrap_pixels": int(n),
        "quality_rmse_wrap": float(np.sqrt(np.mean(on ** 2))) if n else 0.0,
        "wrap_mean_diff": [float(x) for x in (on.mean(axis=0) if n else np.zeros(3))],
        "wrap_mean_se": [float(x) for x in
                         (on.std(axis=0, ddof=1) / np.sqrt(n) if n > 1 else np.zeros(3))],
    }
    line["quality_ok"] = not gate_failures(line)
    return line


def gate_failures(line: dict) -> list[str]:
    """The parts of quality_gate's line that miss the gate, in words."""
    out = []
    if not line["quality_rmse_off_wrap"] < QUALITY_RMSE_BUDGET:
        out.append(f"RMSE off the texel-edge pixels {line['quality_rmse_off_wrap']:.3e} >= "
                   f"{QUALITY_RMSE_BUDGET}")
    if line["wrap_pixels"] > 1 and not all(
            abs(m) <= WRAP_MEAN_SIGMAS * e
            for m, e in zip(line["wrap_mean_diff"], line["wrap_mean_se"])):
        out.append(f"mean difference on the {line['wrap_pixels']} texel-edge pixels "
                   f"{line['wrap_mean_diff']} beyond {WRAP_MEAN_SIGMAS} x {line['wrap_mean_se']}")
    if not line["quality_rmse_wrap"] <= WRAP_RMSE_JAX_CPU:
        out.append(f"RMSE on the texel-edge pixels {line['quality_rmse_wrap']:.3e} > "
                   f"{WRAP_RMSE_JAX_CPU}")
    return out


def quality_image(scene, sky, camera, *, width, height, num_frames, engine,
                  num_bounces=4, exposure=EXPOSURE) -> np.ndarray:
    """The bench's accumulation (two num_frames dispatches, from frame 0 and
    from frame num_frames, spp 256, counting rays) as a tonemapped mean
    image (mean_image)."""
    dev = scene.device
    tile = torch.from_numpy(blue_noise_tile()).to(dev)
    accum = torch.zeros(width * height, 3, device=dev)
    for base in (0, num_frames):
        accum, _ = accumulate_samples_regen(
            scene, sky, camera, tile, base, accum, width=width, height=height,
            num_bounces=num_bounces, spp=256, num_frames=num_frames, engine=engine,
            count_rays=True)
    return mean_image(accum, 2 * num_frames, width, height, exposure)


def courtyard_config(device="cuda"):
    """The courtyard golden's configuration: courtyard_scene(26, textured=True)
    built procedurally (as the golden was baked), the bench's camera and sky.
    Returns (scene, sky, camera, quality_image keywords)."""
    flat, textures = courtyard_scene(26, textured=True)
    scene = build_device_scene(flat, textures=textures, device=device)
    camera = create_camera(*BENCH_CAMERA, 1.0)
    return scene, sky_state_from_ui(*BENCH_SKY), camera, dict(width=512, height=512,
                                                                 num_frames=16)
