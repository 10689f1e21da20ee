"""The deferred renderer, as the viewer drives it while the user flies:
one `DeferredRenderer.render(camera, sky, exposure)` per frame, the camera
at the mix's next pose, the frame's float image on the host.

The window starts from a fresh temporal history
(`invalidate_temporal_accumulation`, as after a resize), so its frames are
frames 0, 1, ... of the renderer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import render as ref_render
from ..reference import sky as ref_sky
from .common import pixels_u8, run_loop, sync

CHUNK = 1 << 19


class User:
    def __init__(self, scene, config: dict, mix: dict, session, device, count_rays: bool):
        from rayfinder_tpu_torch.render.camera import create_camera
        from rayfinder_tpu_torch.render.deferred import DeferredRenderer
        from rayfinder_tpu_torch.sky.model import sky_state_from_ui

        if mix["kind"] != "fly":
            raise ValueError(f"the deferred renderer takes fly mixes, not {mix['kind']!r}")
        self.config, self.mix, self.session, self.device = config, mix, session, device
        w, h = config["width"], config["height"]
        cam, sky = config["camera"], config["sky"]
        self._camera = lambda eye, look: create_camera(
            eye, look, cam["aperture"], cam["focus_distance"], cam["vfov_degrees"], w / h)
        self.sky = sky_state_from_ui(sky["turbidity"], tuple(sky["albedo"]),
                                     sky["sun_zenith_degrees"], sky["sun_azimuth_degrees"])
        self.renderer = DeferredRenderer(scene, w, h, engine=config["engine"])

    def warm(self) -> None:
        """Frame 0 (a copy into the history) and a blended frame."""
        for k in range(3):
            self.renderer.render(self._camera(*self.session.pose(k)), self.sky,
                                 self.config["exposure"])
        sync(self.device)
        self.renderer.invalidate_temporal_accumulation()

    def rays(self):
        return None

    def window(self, seconds: float, trace: bool):
        r, s = self.renderer, self.session
        w, h = self.config["width"], self.config["height"]

        def step(k):
            frame = r.frame_count
            image = r.render(self._camera(*s.pose(k)), self.sky, self.config["exposure"])
            return dict(pose=k, frame_base=frame, added=1, count=1, samples=w * h,
                        out=pixels_u8(image, s.ys, s.xs))

        return run_loop(step, seconds, trace)

    def close(self) -> None:
        del self.renderer


def reference(gen_scene, config: dict, mix: dict, session, frames, device,
              dtype=torch.float32, counter=None) -> np.ndarray:
    """The display bytes (F, P, 3) the reference gives for the check's pixels
    at each recorded frame: the lighting sample of every frame, blended into
    the history in frame order (frame 0 copied, then 0.1 x new + 0.9 x old),
    tonemapped."""
    w, h = config["width"], config["height"]
    cam, sky_cfg = config["camera"], config["sky"]
    scene = ref_render.make_scene(gen_scene, device, dtype)
    sky = ref_sky.sky_state(sky_cfg["turbidity"], sky_cfg["albedo"],
                            sky_cfg["sun_zenith_degrees"], sky_cfg["sun_azimuth_degrees"])
    cams = [ref_render.camera(*session.pose(f["pose"]), cam["aperture"], cam["focus_distance"],
                              cam["vfov_degrees"], w / h) for f in frames]
    p, n = len(session.ys), len(frames)
    ys = torch.from_numpy(session.ys).to(device).repeat(n)
    xs = torch.from_numpy(session.xs).to(device).repeat(n)
    fr = torch.tensor([f["frame_base"] for f in frames], dtype=torch.long,
                      device=device).repeat_interleave(p)
    which = torch.arange(n, device=device).repeat_interleave(p)
    rad = []
    for a in range(0, n * p, CHUNK):
        rows = slice(a, a + CHUNK)
        rad.append(ref_render.deferred_samples(
            scene, sky, ref_render.camera_rows(cams, which[rows], device), ys[rows], xs[rows],
            fr[rows], width=w, height=h, counter=counter).float())
    rad = torch.cat(rad).reshape(n, p, 3)
    out = np.empty((n, p, 3), np.uint8)
    acc = None
    for i, f in enumerate(frames):
        acc = rad[i] if f["frame_base"] == 0 else 0.1 * rad[i] + 0.9 * acc
        out[i] = ref_render.tonemap_u8(acc, config["exposure"]).cpu().numpy()
    return out
