"""The progressive path tracer, as the viewer drives it: `Renderer` with
`set_render_parameters`, `render(n)` and `image_u8()`.

It takes converge mixes: the camera stays at one pose until `spp` samples
per pixel are in, in batches of `batch` samples, each batch one
`render(batch)` and one `image_u8()`; then the next pose, which resets the
accumulation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import render as ref_render
from ..reference import sky as ref_sky
from .common import pixels_u8, run_loop, sync

# Rays a reference call takes at once.
CHUNK = 1 << 19


class User:
    def __init__(self, scene, config: dict, mix: dict, session, device, count_rays: bool):
        from rayfinder_tpu_torch.render.camera import create_camera
        from rayfinder_tpu_torch.render.pathtracer import SamplingParams
        from rayfinder_tpu_torch.render.renderer import Renderer, RenderParameters, Sky

        if mix["kind"] != "converge":
            raise ValueError(f"the path tracer takes converge mixes, not {mix['kind']!r}")
        self.config, self.mix, self.session = config, mix, session
        self.device = device
        w, h = config["width"], config["height"]
        cam = config["camera"]
        sky = config["sky"]

        def params(eye, look, exposure=config["exposure"]):
            camera = create_camera(eye, look, cam["aperture"], cam["focus_distance"],
                                   cam["vfov_degrees"], w / h)
            return RenderParameters(
                w, h, camera, SamplingParams(mix["spp"], mix["bounces"]),
                Sky(sky["turbidity"], tuple(sky["albedo"]), sky["sun_zenith_degrees"],
                    sky["sun_azimuth_degrees"]), exposure)

        self._params = params
        eye, look = session.pose(0)
        # The warm-up's pose is off the session's, so that the window's first
        # frame resets the accumulation as a new pose does.
        self.renderer = Renderer(scene, params([eye[0], eye[1] + 0.25, eye[2]], look),
                                 engine=config["engine"], count_rays=count_rays)
        self.renderer.frame_count = session.start_frame

    def warm(self) -> None:
        """The window's shapes once each: a dispatch of `batch` samples at
        the cell's size, and the readback."""
        for _ in range(2):
            self.renderer.render(self.mix["batch"])
            self.renderer.image_u8()
        sync(self.device)

    def rays(self):
        return self.renderer.total_rays

    def window(self, seconds: float, trace: bool):
        r, mix, s = self.renderer, self.mix, self.session
        w, h = self.config["width"], self.config["height"]
        state = {"pose": -1}

        def step(k):
            if state["pose"] < 0 or r.accumulated_sample_count >= mix["spp"]:
                state["pose"] += 1
                r.set_render_parameters(self._params(*s.pose(state["pose"])))
            frame_base, before = r.frame_count, r.accumulated_sample_count
            r.render(mix["batch"])
            image = r.image_u8()
            added = r.accumulated_sample_count - before
            return dict(pose=state["pose"], frame_base=frame_base, added=added,
                        count=r.accumulated_sample_count, samples=w * h * added,
                        out=pixels_u8(image, s.ys, s.xs))

        return run_loop(step, seconds, trace)

    def close(self) -> None:
        del self.renderer


def reference(gen_scene, config: dict, mix: dict, session, frames, device,
              dtype=torch.float32, counter=None) -> np.ndarray:
    """The display bytes (F, P, 3) that the reference gives for the check's
    pixels after each recorded frame: every sample of every pose, added in
    sample order, the running mean tonemapped."""
    w, h = config["width"], config["height"]
    cam, sky_cfg = config["camera"], config["sky"]
    scene = ref_render.make_scene(gen_scene, device, dtype)
    sky = ref_sky.sky_state(sky_cfg["turbidity"], sky_cfg["albedo"],
                            sky_cfg["sun_zenith_degrees"], sky_cfg["sun_azimuth_degrees"])
    poses = sorted({f["pose"] for f in frames})
    cams = [ref_render.camera(*session.pose(k), cam["aperture"], cam["focus_distance"],
                              cam["vfov_degrees"], w / h) for k in poses]
    slot = {k: i for i, k in enumerate(poses)}
    p = len(session.ys)
    # Every sample of the window: (pose slot, frame index) per sample, in order.
    sample_pose, sample_frame = [], []
    for f in frames:
        for j in range(f["added"]):
            sample_pose.append(slot[f["pose"]])
            sample_frame.append(f["frame_base"] + j)
    n = len(sample_frame)
    ys = torch.from_numpy(session.ys).to(device).repeat(n)
    xs = torch.from_numpy(session.xs).to(device).repeat(n)
    fr = torch.tensor(sample_frame, dtype=torch.long, device=device).repeat_interleave(p)
    which = torch.tensor(sample_pose, dtype=torch.long, device=device).repeat_interleave(p)
    rad = []
    for a in range(0, n * p, CHUNK):
        rows = slice(a, a + CHUNK)
        rad.append(ref_render.pt_samples(
            scene, sky, ref_render.camera_rows(cams, which[rows], device), ys[rows], xs[rows],
            fr[rows], width=w, height=h, spp=mix["spp"], bounces=mix["bounces"],
            counter=counter).float())
    rad = torch.cat(rad).reshape(n, p, 3)
    out = np.empty((len(frames), p, 3), np.uint8)
    acc = torch.zeros(p, 3, device=device)
    i = 0
    for fi, f in enumerate(frames):
        if f["count"] == f["added"]:  # the pose's first frame
            acc = torch.zeros(p, 3, device=device)
        for _ in range(f["added"]):
            acc = acc + rad[i]
            i += 1
        out[fi] = ref_render.tonemap_u8(acc / float(max(1, f["count"])),
                                        config["exposure"]).cpu().numpy()
    return out
