"""rayfinder_tpu_torch: the path tracer in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of `rayfinder_tpu` (JAX/Pallas on TPU). Module names follow the JAX
package so each counterpart is easy to find. The hot path is the fused path
regeneration loop (`render.pathtracer.accumulate_samples_regen`), driven by
CUDA kernels built at first use from `csrc/` (see `ops/_build.py`): closest
hit, any hit and the persistent trace/sky/regenerate kernel, with its
in-kernel-shaded (`inkernel=True`) and multi-segment (`segs=K`) forms for
the loop's two other routes. The scan integrator (`accumulate_samples`,
`render_image_tiled`) and the unfused loop (`engine="kernel_split"`) trace
with the closest-hit and any-hit kernels; `render.renderer.Renderer` is the
progressive renderer over them. Every kernel has a plain PyTorch version
beside it; a wrapper takes it only for tensors that lie on the CPU. The package
imports nothing of `rayfinder_tpu`: the host code it needs (scene loading,
BVH build, the `.pt` format, assets) is its own copy.

Quick start::

    import torch
    from rayfinder_tpu_torch import build_device_scene, render_image, SamplingParams, create_camera
    from rayfinder_tpu_torch.scene.procedural import courtyard_scene
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    flat, textures = courtyard_scene(8)
    scene = build_device_scene(flat, textures=textures)  # on the card
    camera = create_camera([-16, 5, 0], [12, 2, 0], 0.0, 1.0, 70.0, 4 / 3)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    img = render_image(scene, sky, camera, width=640, height=480,
                       sampling=SamplingParams(64, 4))
"""

__version__ = "0.1.0"

_LAZY = {
    "build_device_scene": "render.scene",
    "load_device_scene": "render.scene",
    "DeviceScene": "render.scene",
    "render_image": "render.pathtracer",
    "render_image_tiled": "render.pathtracer",
    "accumulate_samples_regen": "render.pathtracer",
    "accumulate_samples": "render.pathtracer",
    "SamplingParams": "render.pathtracer",
    "Renderer": "render.renderer",
    "RenderParameters": "render.renderer",
    "Sky": "render.renderer",
    "create_camera": "render.camera",
    "Camera": "render.camera",
}


def __getattr__(name):
    # Lazy exports keep `import rayfinder_tpu_torch` free of torch
    # initialization.
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module 'rayfinder_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))


__all__ = sorted(_LAZY)
