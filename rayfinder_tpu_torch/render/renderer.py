"""Progressive path-tracing renderer with the reference's public API.

Counterpart of `rayfinder_tpu.render.renderer`. Mirrors ReferencePathTracer
(src/pt/reference_path_tracer.hpp:26-102):

* RenderParameters {framebuffer size, camera, sampling params, sky, exposure};
* set_render_parameters resets the progressive accumulation only when the
  parameters actually changed (reference_path_tracer.cpp:556-563);
* render() advances one frame: adds one sample per pixel while
  accumulated < spp, while the frame counter keeps advancing the noise
  sequence regardless (fsMain, wgsl:45-57; host counters
  reference_path_tracer.cpp:577-591);
* render_progress_percentage and a 30-entry rolling average of render-pass
  durations (reference_path_tracer.cpp:706-722).

The accumulation buffer lives on the scene's device. Checkpoints hold the
same npz keys and the same parameter digest as the JAX package's, so either
package resumes the other's.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time

import numpy as np
import torch

from ..sky.model import SkyState, sky_state_from_ui
from ..utils import profiling
from .camera import Camera
from .pathtracer import SamplingParams, accumulate_samples_regen, pick_accumulator
from .rng import blue_noise_tile
from .scene import DeviceScene
from .tiling import unswizzle
from .tonemap import tonemap


def _display_u8(estimator, exposure: float):
    """Tonemap and quantize to uint8 on the estimator's device."""
    img = tonemap(estimator, exposure)
    return torch.clamp(torch.round(img * 255.0), 0.0, 255.0).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class Sky:
    """UI-level sky parameters (aligned_sky_state.hpp:15-23)."""

    turbidity: float = 1.0
    albedo: tuple = (1.0, 1.0, 1.0)
    sun_zenith_degrees: float = 30.0
    sun_azimuth_degrees: float = 0.0

    def state(self) -> SkyState:
        return sky_state_from_ui(
            self.turbidity, self.albedo, self.sun_zenith_degrees, self.sun_azimuth_degrees
        )


@dataclasses.dataclass(frozen=True)
class RenderParameters:
    """reference_path_tracer.hpp:41-49."""

    width: int
    height: int
    camera: Camera
    sampling: SamplingParams = SamplingParams()
    sky: Sky = Sky()
    exposure: float = 1.0

    def _key(self):
        """The parameters as plain Python values (the camera's float32
        fields as floats): equal keys mean equal renders, and the key's
        repr is the JAX package's for the same parameters."""
        cam = tuple(np.concatenate([np.ravel(f) for f in self.camera]).tolist())
        return (
            self.width,
            self.height,
            cam,
            tuple(self.sampling),
            dataclasses.astuple(self.sky),
            self.exposure,
        )

    def _digest(self) -> str:
        """Stable checkpoint-integrity key: repr of the key tuple hashed with
        sha256 (Python's hash() is salted per process)."""
        return hashlib.sha256(repr(self._key()).encode()).hexdigest()


class Renderer:
    """Progressive accumulation renderer over a DeviceScene, on its device.

    engine: "kernel" (default), "plain", "kernel_split" or "reference"; the
    accumulator is pick_accumulator's. count_rays: accumulate the exact
    traced-segment counts in total_rays, the interior records that K4's
    walks read (closest and shadow; every walk of the default route) in
    total_walk_records and the triangles they test in total_walk_tests,
    which each render() also adds to the counters rf.walk_records and
    rf.walk_tests (utils/profiling.py count), read back with the rays once a
    dispatch. Only the regeneration loop counts; where the scan form is
    picked (big scenes on the unfused engines), all three become None at the
    first render(), so that "not counted" reads apart from 0."""

    def __init__(
        self,
        scene: DeviceScene,
        params: RenderParameters,
        engine: str = "kernel",
        count_rays: bool = False,
    ):
        self.scene = scene
        self.engine = engine
        self._count_rays = count_rays
        self.total_rays = 0 if count_rays else None
        self.total_walk_records = 0 if count_rays else None
        self.total_walk_tests = 0 if count_rays else None
        self._tile = torch.from_numpy(blue_noise_tile()).to(scene.device)
        self._durations = collections.deque(maxlen=30)
        self._params = params
        self._sky_state = params.sky.state()
        self.frame_count = 0
        self._reset()

    def _reset(self) -> None:
        # Only the accumulation resets; the frame counter keeps advancing the
        # noise sequence across parameter changes
        # (reference_path_tracer.cpp:556-563: mAccumulatedSampleCount = 0).
        p = self._params
        self.accumulated_sample_count = 0
        self._accum = torch.zeros(p.height * p.width, 3, device=self.scene.device)

    def set_render_parameters(self, params: RenderParameters) -> None:
        """Reset the accumulation only on an actual change
        (reference_path_tracer.cpp:556-563)."""
        if params._key() != self._params._key():
            sky_changed = dataclasses.astuple(params.sky) != dataclasses.astuple(self._params.sky)
            self._params = params
            if sky_changed:
                self._sky_state = params.sky.state()
            self._reset()

    def render(self, num_frames: int = 1) -> None:
        """Advance num_frames frames; each adds one sample per pixel while
        the target spp is not reached (the frame counter always advances).
        The pass time recorded is the frame's: the scene's device is
        synchronised before the end time is read."""
        p = self._params
        t0 = time.perf_counter()
        with profiling.span("rf.pt.render", frame=self.frame_count):
            remaining = p.sampling.num_samples_per_pixel - self.accumulated_sample_count
            to_add = max(0, min(num_frames, remaining))
            if to_add > 0:
                accumulate = pick_accumulator(self.scene, self.engine)
                kw = dict(
                    width=p.width,
                    height=p.height,
                    num_bounces=p.sampling.num_bounces,
                    spp=p.sampling.num_samples_per_pixel,
                    num_frames=to_add,
                    engine=self.engine,
                )
                counting = self._count_rays and accumulate is accumulate_samples_regen
                if counting:
                    kw["count_rays"] = True
                    for name in ("walk_records", "walk_tests"):
                        kw[name] = torch.zeros(1, dtype=torch.int64, device=self.scene.device)
                elif self._count_rays:
                    # counting unavailable on this path
                    self.total_rays = self.total_walk_records = self.total_walk_tests = None
                out = accumulate(
                    self.scene, self._sky_state, p.camera, self._tile, self.frame_count,
                    self._accum, **kw,
                )
                if counting:
                    self._accum, rays = out
                    closest, shadow, records, tests = torch.cat(
                        [rays, kw["walk_records"], kw["walk_tests"]]).tolist()
                    self.total_rays += closest + shadow
                    self.total_walk_records += records
                    self.total_walk_tests += tests
                    profiling.count(profiling.WALK_RECORDS, records)
                    profiling.count(profiling.WALK_TESTS, tests)
                else:
                    self._accum = out
                self.accumulated_sample_count += to_add
            self.frame_count += num_frames
            if self.scene.device.type == "cuda":
                with profiling.span("rf.pt.sync"):
                    torch.cuda.synchronize(self.scene.device)
        self._durations.append(time.perf_counter() - t0)

    def render_progress_percentage(self) -> float:
        """reference_path_tracer.cpp:718-722."""
        return 100.0 * self.accumulated_sample_count / self._params.sampling.num_samples_per_pixel

    def average_render_pass_duration_ms(self) -> float:
        """30-frame rolling average (reference_path_tracer.cpp:706-716)."""
        if not self._durations:
            return 0.0
        return 1000.0 * sum(self._durations) / len(self._durations)

    def _estimator(self):
        p = self._params
        count = max(1, self.accumulated_sample_count)
        with profiling.span("rf.pt.unswizzle"):
            return unswizzle(self._accum, p.width, p.height) / float(count)

    def image(self) -> np.ndarray:
        """Tonemapped running-mean estimate, (H, W, 3) float32 in [0, 1]."""
        p = self._params
        img = tonemap(self._estimator(), p.exposure)
        return img.reshape(p.height, p.width, 3).cpu().numpy()

    def image_u8(self) -> np.ndarray:
        """Display-ready 8-bit frame, tonemapped and quantized on the device
        (a quarter of image()'s bytes to copy): image() * 255, rounded half
        to even and clamped. Its spans share the last render()'s frame."""
        p = self._params
        with profiling.span("rf.pt.image"):
            estimator = self._estimator()
            with profiling.span("rf.pt.display"):
                img8 = _display_u8(estimator, p.exposure)
            with profiling.span("rf.pt.readback"):
                return img8.reshape(p.height, p.width, 3).cpu().numpy()

    # -- checkpoint / resume (beyond the reference, whose render state lived
    # in GPU memory and was lost on any parameter change) ------------------

    def save_checkpoint(self, path) -> None:
        """Persist the progressive accumulation so a render can resume
        across processes and preemptions."""
        np.savez_compressed(
            path,
            accum=self._accum.cpu().numpy(),
            accumulated_sample_count=self.accumulated_sample_count,
            frame_count=self.frame_count,
            params_key=np.asarray(self._params._digest()),
        )

    def load_checkpoint(self, path) -> None:
        """Resume from a checkpoint; refuses on mismatched render parameters."""
        with np.load(path) as data:
            if str(data["params_key"]) != self._params._digest():
                raise ValueError("checkpoint was created with different render parameters")
            self._accum = torch.from_numpy(data["accum"]).to(self.scene.device)
            self.accumulated_sample_count = int(data["accumulated_sample_count"])
            self.frame_count = int(data["frame_count"])
