"""Bake the golden images that the PyTorch port's render is held to.

Renders the untextured and the textured courtyard (courtyard_scene(8)) at
128x96, 8 spp, 4 bounces with the JAX package on CPU
(accumulate_samples_regen, engine="reference": the per-ray stack walk),
tonemaps them with exposure 0.25 and writes
tests/goldens/courtyard_untextured_128x96_8spp.npz and
tests/goldens/courtyard_textured_128x96_8spp.npz. The same configurations
are rendered through the port by chip_smoke.py (phases 3 and 3b) and by
tests/test_torch_golden.py.

It also renders three frames of the deferred renderer (DeferredRenderer,
engine="reference") on both scenes at 128x96 with the same camera, sky and
exposure, and writes tests/goldens/courtyard_deferred_128x96_f3.npz: per
scene the TAA accumulator after the third frame, the third frame's u8
display and the G-buffer debug triptych at frame count 3
(chip_smoke.py phase 10, tests/test_torch_deferred.py).

    JAX_PLATFORMS=cpu python tests/goldens/bake_torch_smoke.py [--deferred]

(--deferred: the deferred golden only.)
"""

import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

GOLDENS = pathlib.Path(__file__).resolve().parent


def golden_path(textured: bool) -> pathlib.Path:
    kind = "textured" if textured else "untextured"
    return GOLDENS / f"courtyard_{kind}_128x96_8spp.npz"


# The configuration, shared with chip_smoke.py and the CPU test.
WIDTH, HEIGHT, SPP, BOUNCES, SUBDIV, EXPOSURE = 128, 96, 8, 4, 8, 0.25
CAMERA = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0)
SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)


def bake(textured: bool) -> None:
    import jax.numpy as jnp

    from rayfinder_tpu.render.camera import create_camera
    from rayfinder_tpu.render.pathtracer import accumulate_samples_regen
    from rayfinder_tpu.render.rng import blue_noise_tile
    from rayfinder_tpu.render.scene import build_device_scene
    from rayfinder_tpu.render.tiling import unswizzle
    from rayfinder_tpu.render.tonemap import tonemap
    from rayfinder_tpu.scene.procedural import courtyard_scene
    from rayfinder_tpu.sky.model import sky_state_from_ui

    flat, textures = courtyard_scene(SUBDIV, textured=textured)
    scene = build_device_scene(flat, textures=textures)
    camera = create_camera(*CAMERA, WIDTH / HEIGHT)
    sky = sky_state_from_ui(*SKY)
    accum, rays = accumulate_samples_regen(
        scene, sky, camera, jnp.asarray(blue_noise_tile()), jnp.int32(0),
        jnp.zeros((WIDTH * HEIGHT, 3), jnp.float32),
        width=WIDTH, height=HEIGHT, num_bounces=BOUNCES, spp=SPP,
        num_frames=SPP, engine="reference", count_rays=True,
    )
    img = tonemap(unswizzle(accum, WIDTH, HEIGHT) / jnp.float32(SPP), EXPOSURE)
    img = np.asarray(img).reshape(HEIGHT, WIDTH, 3).astype(np.float32)
    out = golden_path(textured)
    np.savez_compressed(out, image=img, rays=np.asarray(rays).astype(np.int64))
    print(f"wrote {out} rays={np.asarray(rays).tolist()}")


DEFERRED_FRAMES = 3
DEFERRED_GOLDEN = GOLDENS / "courtyard_deferred_128x96_f3.npz"


def bake_deferred() -> None:
    from rayfinder_tpu.render.camera import create_camera
    from rayfinder_tpu.render.deferred import DeferredRenderer
    from rayfinder_tpu.render.scene import build_device_scene
    from rayfinder_tpu.scene.procedural import courtyard_scene
    from rayfinder_tpu.sky.model import sky_state_from_ui

    out = {}
    for textured in (False, True):
        kind = "textured" if textured else "untextured"
        flat, textures = courtyard_scene(SUBDIV, textured=textured)
        scene = build_device_scene(flat, textures=textures)
        camera = create_camera(*CAMERA, WIDTH / HEIGHT)
        dr = DeferredRenderer(scene, WIDTH, HEIGHT, engine="reference")
        for _ in range(DEFERRED_FRAMES):
            img = dr.render(camera, sky_state_from_ui(*SKY), EXPOSURE)
        out[f"{kind}_accum"] = np.asarray(dr.accum).astype(np.float32)
        out[f"{kind}_display"] = np.round(img * 255.0).astype(np.uint8)
        out[f"{kind}_debug"] = dr.render_debug(camera).astype(np.float32)
    np.savez_compressed(DEFERRED_GOLDEN, **out)
    print(f"wrote {DEFERRED_GOLDEN}")


if __name__ == "__main__":
    if "--deferred" not in sys.argv[1:]:
        for textured in (False, True):
            bake(textured)
    bake_deferred()
