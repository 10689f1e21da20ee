"""Hybrid deferred renderer: ray-traced G-buffer + 2-bounce lighting + TAA.

Counterpart of `rayfinder_tpu.render.deferred` (the reference's
DeferredRenderer, src/pt/deferred_renderer.{hpp,cpp}). The raster G-buffer
pass is emulated with one primary-ray query per pixel, which gives the same
per-pixel surface data; the lighting and resolve passes follow the
reference:

* **G-buffer** (deferred_renderer_gbuffer_pass.wgsl): a per-frame R2
  sub-pixel jitter shared by all pixels (deferred_renderer.cpp:309-315);
  linear albedo quantized to 8 bits (the reference's BGRA8Unorm target), the
  interpolated vertex normal, the world-space position and a hit mask.
* **Lighting** (deferred_renderer_lighting_pass.wgsl:96-236): a miss takes
  the sky WITH the solar disk; a hit takes an NEE light sample plus a fixed
  2-bounce Lambertian path, with animatedBlueNoise(coord, frameCount, 1<<20)
  and the lighting pass's own ray-offset constants (INT_SCALE=1024,
  FLOAT_SCALE=1/16384).
* **Resolve** (deferred_renderer_resolve_pass.wgsl:41-63): frame 0 copies,
  later frames blend 0.1*current + 0.9*accumulated, then ACES + gamma.
* **Debug** (deferred_renderer_debug_pass.wgsl:25-42): albedo / encoded
  normal / depth triptych split at x = 1/3, 2/3.

A frame makes four ray queries of width x height rays through get_engine:
on the default engine "kernel" the closest-hit kernel K1 (primaries and
bounce rays) and the any-hit kernel K2 (the two sun samples), ops/walk.py.
On a CUDA scene with the engine "kernel" the passes' arithmetic around them
runs in CUDA kernels too (ops/deferred.py, csrc/deferred.cu), which give
these torch passes' results bit for bit; every other engine, and every CPU
scene, runs the passes below in torch on the scene's device.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..sky.model import SkyState, sky_on_device, sky_radiance
from ..utils import profiling
from .camera import Camera, generate_camera_ray
from .intersect import T_MAX, dot, offset_ray
from .pathtracer import get_engine
from .rng import animated_blue_noise, blue_noise_tile
from .sampling import sample_cosine_hemisphere, sample_solar_disk_direction
from .scene import DeviceScene
from .shade import FRAC_1_PI, SOLAR_COS_THETA_MAX, SOLAR_INV_PDF, _surface_interaction
from .texture_eval import eval_texture
from .tonemap import tonemap

# deferred_renderer_lighting_pass.wgsl:500-502
_DEFERRED_INT_SCALE = 1024.0
_DEFERRED_FLOAT_SCALE = 1.0 / 16384.0
_NOISE_PERIOD = 1 << 20  # animatedBlueNoise period in the deferred path

# The frame's passes, each a device span of frame_pass (rf.deferred.<pass>).
PASSES = ("gbuffer", "lighting", "resolve")

# R2 jitter constants (r_sequence.hpp:11-22), rounded from f64 as JAX does.
_A1 = np.float32(1.0 / 1.32471795)
_A2 = np.float32(1.0 / (1.32471795**2))


def _on_kernels(scene: DeviceScene, engine: str) -> bool:
    """Whether the passes run as CUDA kernels: a CUDA scene on "kernel"."""
    return engine == "kernel" and scene.device.type == "cuda"


def _kernels():
    """ops/deferred.py, the passes' kernels (imported at first use: it
    imports this module)."""
    from ..ops import deferred

    return deferred


def _closest(scene, o, d, engine):
    hit, t, tri, _ = get_engine(engine)[0](scene, o, d, o.new_full((o.shape[0],), T_MAX))
    return hit, t, tri


def _any(scene, o, d, engine):
    return get_engine(engine)[1](scene, o, d, o.new_full((o.shape[0],), T_MAX))


def _recip(c: int) -> float:
    """1/c rounded to float32. XLA compiles a division by a constant into a
    multiply by its float32 reciprocal; the G-buffer's divisions by the
    image size and by 255 do the same, so that it equals the JAX package's
    bit for bit where the rays agree."""
    return float(np.float32(1.0) / np.float32(c))


def _pixels(width: int, height: int, dev):
    """(ys, xs) of every pixel in row-major order, int32."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.int32, device=dev),
                            torch.arange(width, dtype=torch.int32, device=dev), indexing="ij")
    return ys.reshape(-1), xs.reshape(-1)


def _jitter(frame_count: int) -> tuple[float, float]:
    """The frame's sub-pixel jitter minus one half, (jx - 0.5, jy - 0.5), in
    float32 as the JAX package computes it (deferred_renderer.cpp:309-315):
    jx = (0.5 + a1 * n) mod 1, with n = frame_count mod 2^20."""
    n = np.float32(frame_count % _NOISE_PERIOD)
    half, one = np.float32(0.5), np.float32(1.0)
    jx = np.remainder(half + _A1 * n, one)
    jy = np.remainder(half + _A2 * n, one)
    return float(np.float32(jx - half)), float(np.float32(jy - half))


def gbuffer_pass(
    scene: DeviceScene,
    camera: Camera,
    frame_count: int,
    *,
    width: int,
    height: int,
    engine: str = "kernel",
):
    """Primary-ray G-buffer on the scene's device. Returns a dict of flat
    (H*W, ...) planes: hit, position, normal, albedo, depth (0 = miss, like
    reverse-Z) and view_dir."""
    if _on_kernels(scene, engine):
        return _kernels().gbuffer_kernel(scene, camera, frame_count, width=width,
                                         height=height)
    ys, xs = _pixels(width, height, scene.device)
    jx, jy = _jitter(int(frame_count))
    u = (xs.to(torch.float32) + 0.5 + jx) * _recip(width)
    v = 1.0 - (ys.to(torch.float32) + 0.5 + jy) * _recip(height)
    origin, direction = generate_camera_ray(camera, u, v)

    hit, t, tri = _closest(scene, origin, direction, engine)
    _, normal, uv, tex = _surface_interaction(scene, origin, direction, tri.clamp(min=0))
    albedo = eval_texture(scene, tex, uv)
    # BGRA8Unorm quantization of the linear albedo (round half to even).
    albedo = torch.round(albedo * 255.0) * _recip(255)

    # The exact hit position: the lighting pass applies its own offset.
    position = origin + t[:, None] * direction

    h3 = hit[:, None]
    return dict(
        hit=hit,
        position=torch.where(h3, position, 0.0),
        normal=torch.where(h3, normal, 0.0),
        albedo=torch.where(h3, albedo, 0.0),
        depth=torch.where(hit, t, 0.0),
        view_dir=direction,
    )


def _sky(sky: SkyState, direction, sun_dir):
    """Sky radiance WITH the solar disk toward unit directions (B, 3)."""
    theta = torch.acos(direction[:, 1].clamp(-1.0, 1.0))
    gamma = torch.acos(dot(direction, sun_dir).clamp(-1.0, 1.0))
    return sky_radiance(sky, theta, gamma)


def lighting_pass(
    scene: DeviceScene,
    sky: SkyState,
    gbuffer: dict,
    frame_count: int,
    *,
    width: int,
    height: int,
    engine: str = "kernel",
    tile=None,
):
    """2-bounce lighting from the G-buffer (lighting_pass.wgsl:96-236).
    tile: the (128, 128, 2) blue-noise tile on the scene's device (loaded
    when None). Returns (H*W, 3) radiance samples."""
    if _on_kernels(scene, engine):
        return _kernels().lighting_kernel(scene, sky, gbuffer, frame_count, width=width,
                                          height=height, tile=tile)
    dev = scene.device
    ys, xs = _pixels(width, height, dev)
    noise = animated_blue_noise(ys, xs, int(frame_count), _NOISE_PERIOD, tile=tile)

    hit = gbuffer["hit"]
    sky = sky_on_device(sky, dev)
    sun_dir, solar = sky.sun_direction, sky.solar_radiances

    # Miss: sky WITH the solar disk (lighting_pass.wgsl:107-118).
    sky_rgb = _sky(sky, gbuffer["view_dir"], sun_dir)

    # Hit: offset position with the deferred constants, then NEE + 1 scatter.
    normal = gbuffer["normal"]
    position = offset_ray(gbuffer["position"], normal, _DEFERRED_INT_SCALE,
                          _DEFERRED_FLOAT_SCALE)
    albedo = gbuffer["albedo"]
    light_dir = sample_solar_disk_direction(noise, SOLAR_COS_THETA_MAX, sun_dir)

    def light_sample(pos, nrm, alb):
        # No clamp on the cosine -- the reference's arithmetic.
        cos_term = dot(nrm, light_dir)[:, None]
        occluded = _any(scene, pos, light_dir, engine)
        vis = torch.where(occluded, 0.0, 1.0)[:, None]
        return solar * (alb * float(FRAC_1_PI)) * cos_term * vis * float(SOLAR_INV_PDF)

    radiance = light_sample(position, normal, albedo)
    throughput = albedo  # applied before the single indirect bounce

    # Bounce 1 of NUM_BOUNCES=2 (lighting_pass.wgsl:154-185). A missed
    # bounce is shaded on triangle 0 and dropped by the where below.
    wi = sample_cosine_hemisphere(noise, normal)
    b_hit, _, b_tri = _closest(scene, position, wi, engine)
    # The bounce surface takes the path tracer's offset constants
    # (rayIntersectTriangle applies offsetRay inside, wgsl:285-521).
    b_pos, b_nrm, b_uv, b_tex = _surface_interaction(scene, position, wi, b_tri.clamp(min=0))
    b_alb = eval_texture(scene, b_tex, b_uv)
    b_sky = _sky(sky, wi, sun_dir)

    indirect_hit = throughput * light_sample(b_pos, b_nrm, b_alb)
    indirect_miss = throughput * b_sky
    radiance = radiance + torch.where(b_hit[:, None], indirect_hit, indirect_miss)
    return torch.where(hit[:, None], radiance, sky_rgb)


def resolve_pass(sample, accum, frame_count: int, exposure: float):
    """Temporal exponential blend + tonemap (resolve_pass.wgsl:34-63).
    Returns (new_accum, display u8 (H*W, 3)): the reference's swapchain
    target is BGRA8Unorm, so the frame leaves the device as 8 bits. This
    pass has no scene or engine to choose by, so frame_pass takes its
    kernel (ops/deferred.py resolve_kernel) in its place on a CUDA scene
    with the engine "kernel"."""
    blended = sample if int(frame_count) == 0 else 0.1 * sample + 0.9 * accum
    img = tonemap(blended, exposure)
    img8 = torch.clamp(torch.round(img * 255.0), 0.0, 255.0).to(torch.uint8)
    return blended, img8


def frame_pass(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    accum,
    frame_count: int,
    exposure: float,
    *,
    width: int,
    height: int,
    engine: str = "kernel",
    tile=None,
):
    """One deferred frame: gbuffer -> lighting -> resolve. Returns
    (new_accum, display u8)."""
    with profiling.span("rf.deferred.gbuffer", device=True):
        gbuf = gbuffer_pass(scene, camera, frame_count, width=width, height=height,
                            engine=engine)
    with profiling.span("rf.deferred.lighting", device=True):
        sample = lighting_pass(scene, sky, gbuf, frame_count, width=width, height=height,
                               engine=engine, tile=tile)
    with profiling.span("rf.deferred.resolve", device=True):
        if _on_kernels(scene, engine):
            return _kernels().resolve_kernel(sample, accum, frame_count, exposure)
        return resolve_pass(sample, accum, frame_count, exposure)


def float_table(dev):
    """The float32 value of every display byte b = 0..255 on `dev`: numpy's
    b.astype(float32) / float32(255), so that a gather through it gives
    numpy's bits (torch's CUDA division by a Python scalar multiplies by the
    reciprocal, which differs on 126 of the 256 bytes)."""
    return torch.from_numpy(np.arange(256, dtype=np.uint8).astype(np.float32)
                            / np.float32(255.0)).to(dev)


def to_float(img8, table):
    """The display bytes img8 as float32 through float_table's `table`: one
    cast and one gather on img8's device, in img8's shape."""
    return table.index_select(0, img8.reshape(-1).to(torch.int32)).reshape(img8.shape)


class DeferredRenderer:
    """Stateful frame loop with the reference's public API: render,
    render_debug, resize, invalidate_temporal_accumulation
    (deferred_renderer.hpp:73-75, deferred_renderer.cpp:2055-2060). Lives on
    the scene's device; engine: get_engine's names, "kernel" (K1/K2) by
    default."""

    def __init__(self, scene: DeviceScene, width: int, height: int, engine: str = "kernel"):
        get_engine(engine)
        self.scene = scene
        self.width = width
        self.height = height
        self.engine = engine
        self.frame_count = 0
        self._tile = torch.from_numpy(blue_noise_tile()).to(scene.device)
        self._to_float = float_table(scene.device)
        self._sky_key = None
        self._sky = None
        self.accum = torch.zeros(height * width, 3, device=scene.device)
        # 30-frame rolling frame durations (deferred_renderer.cpp:2031-2053);
        # the passes' times are their spans' (perf_stats).
        self._pass_durations = {"frame": collections.deque(maxlen=30)}

    def resize(self, width: int, height: int) -> None:
        self.width = width
        self.height = height
        self.invalidate_temporal_accumulation()

    def invalidate_temporal_accumulation(self) -> None:
        self.frame_count = 0
        self.accum = torch.zeros(self.height * self.width, 3, device=self.scene.device)

    def _device_sky(self, sky: SkyState) -> SkyState:
        key = tuple(np.asarray(f, np.float32).tobytes() for f in sky)
        if key != self._sky_key:
            self._sky_key, self._sky = key, sky_on_device(sky, self.scene.device)
        return self._sky

    def render(self, camera: Camera, sky: SkyState, exposure: float = 1.0) -> np.ndarray:
        """One frame: the (H, W, 3) float32 image, the device's u8 display
        converted on the device and copied into a new block of page-locked
        host memory (pageable on the CPU), which the caller owns. The time
        recorded spans the frame, the copy and the device sync."""
        dev = self.scene.device
        on_kernels = _on_kernels(self.scene, self.engine)
        t0 = time.perf_counter()
        with profiling.span("rf.deferred.frame", frame=self.frame_count):
            profiling.count(profiling.KERNEL_FRAMES, int(on_kernels))
            # The kernels take the sky by value, from its host state.
            self.accum, img8 = frame_pass(
                self.scene, sky if on_kernels else self._device_sky(sky), camera, self.accum,
                self.frame_count, float(exposure), width=self.width, height=self.height,
                engine=self.engine, tile=self._tile,
            )
            with profiling.span("rf.deferred.to_float"):
                image = to_float(img8, self._to_float).reshape(self.height, self.width, 3)
            with profiling.span("rf.deferred.readback"):
                out = torch.empty(image.shape, dtype=torch.float32,
                                  pin_memory=dev.type == "cuda")
                out.copy_(image, non_blocking=True)
                profiling.count(profiling.D2H_BYTES, out.nbytes)
            if dev.type == "cuda":
                with profiling.span("rf.deferred.sync"):
                    torch.cuda.synchronize(dev)
        self._pass_durations["frame"].append(time.perf_counter() - t0)
        self.frame_count += 1
        return out.numpy()

    def perf_stats(self) -> dict:
        """30-frame rolling averages in ms (DeferredRenderer::getPerfStats,
        deferred_renderer.cpp:2031-2053): "frame", the host's time of a whole
        frame; and while a profiling.recording() block is open, "gbuffer",
        "lighting" and "resolve", each pass's device time over the last 30 of
        its spans there (on the CPU, where a pass's work is done as it is
        queued, its host time)."""
        stats = {name: (1000.0 * sum(d) / len(d) if d else 0.0)
                 for name, d in self._pass_durations.items()}
        rec = profiling.recorder()
        if rec is None:
            return stats
        on_card = self.scene.device.type == "cuda"
        for name in PASSES:
            ms = [s.device_ms if on_card else 1000.0 * (s.t1 - s.t0)
                  for s in rec.spans(f"rf.deferred.{name}")[-30:]]
            ms = [m for m in ms if m is not None]
            if ms:
                stats[name] = sum(ms) / len(ms)
        return stats

    def render_debug(self, camera: Camera) -> np.ndarray:
        """G-buffer triptych: albedo | encoded normal | depth
        (debug_pass.wgsl:25-42), composed on the host."""
        gbuf = gbuffer_pass(self.scene, camera, self.frame_count, width=self.width,
                            height=self.height, engine=self.engine)
        h, w = self.height, self.width
        albedo = gbuf["albedo"].cpu().numpy().reshape(h, w, 3)
        normal = 0.5 * gbuf["normal"].cpu().numpy().reshape(h, w, 3) + 0.5
        depth = gbuf["depth"].cpu().numpy().reshape(h, w)
        a = 0.1
        depth_vis = (1.0 + a) * depth / (depth + a)
        depth_rgb = np.repeat(depth_vis[..., None], 3, axis=-1)

        img = np.zeros((h, w, 3), np.float32)
        third = w // 3
        img[:, :third] = albedo[:, :third]
        img[:, third : 2 * third] = normal[:, third : 2 * third]
        img[:, 2 * third :] = depth_rgb[:, 2 * third :]
        return np.clip(img ** (1.0 / 2.2), 0.0, 1.0)
