"""The port's headless viewer (tools/viewer.py) against the JAX package's:
the same script through both ViewerSessions on courtyard_scene(4),
untextured (the textured one's +x wall reads another texel column than JAX
on a few pixels, tests/test_torch_deferred.py), at 32x24: JAX with
engine="reference", the port with "reference" (its plane walk) and "plain"
(the plain versions of its kernels). The cases of tests/test_viewer.py,
which take the absent Duck fixture, restated.
"""

import numpy as np
import pytest
import torch

from rayfinder_tpu.render.renderer import Sky as JaxSky
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu.tools import viewer as jviewer
from rayfinder_tpu_torch.render.renderer import Sky
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.tools import viewer as pviewer
from rayfinder_tpu_torch.utils.image import read_png, rmse

SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
W, H = 32, 24


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small tensors run faster on one, and the
    tier-1 run shares the machine's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scenes():
    flat, textures = courtyard_scene(4)
    return (build_device_scene(flat, textures=textures, device="cpu"),
            jax_build(flat, textures=textures))


def _sessions(scenes, tmp_path, engine):
    port_scene, jax_scene = scenes
    kw = dict(width=W, height=H, spp=4, bounces=2, exposure=0.25, batch=2)
    port = pviewer.ViewerSession(port_scene, tmp_path / "port.png", sky=Sky(*SKY),
                                 engine=engine, **kw)
    jax_s = jviewer.ViewerSession(jax_scene, tmp_path / "jax.png", sky=JaxSky(*SKY),
                                  engine="reference", **kw)
    for s in (port, jax_s):
        s.handle("lookat 12 2 0")
        s.controller.position = np.asarray([-16.0, 5.0, 0.0], np.float32)
        s.handle("lookat 12 2 0")
    return port, jax_s


def _image(path):
    return read_png(path).astype(np.float32) / 255.0


@pytest.mark.parametrize("engine", ["plain", "reference"])
def test_viewer_script_matches_jax(scenes, tmp_path, engine, capsys):
    """pt frames with the ray readout, a move, a pick, then the deferred and
    debug modes: the focus equal, every PNG within RMSE 5e-3 of JAX's."""
    port, jax_s = _sessions(scenes, tmp_path, engine)
    for line in ("frames 2", "w 0.5", "pick 16 12", "frames 1", "renderer deferred", "frames 2",
                 "renderer debug", "frames 1", "renderer pt", "wait"):
        assert port.handle(line) and jax_s.handle(line)
        np.testing.assert_array_equal(port.controller.position, jax_s.controller.position)
        assert port.controller.focus_distance == jax_s.controller.focus_distance
        if line.startswith(("frames", "wait")):
            assert rmse(_image(port.out_path), _image(jax_s.out_path)) < 5e-3, line
        if line == "frames 2" and port.mode == "pt":
            assert port.renderer.accumulated_sample_count == 2
            assert port.renderer.total_rays == jax_s.renderer.total_rays > 0
            assert "Mrays/s" in port.status()
        if line == "pick 16 12":
            assert port.controller.focus_distance != 10.0
            assert port.renderer.accumulated_sample_count == 0
    out = capsys.readouterr().out
    assert "pick: focus=" in out and "[deferred frame 2]" in out and "[debug frame 2]" in out
    assert port.renderer.accumulated_sample_count == 4
    assert port.renderer.render_progress_percentage() == 100.0
    assert not port.handle("quit")


def test_viewer_deferred_taa_resets_on_move(scenes, tmp_path):
    """A camera move invalidates the deferred renderer's TAA history, and
    `frames 0` in deferred mode renders one frame."""
    port, _ = _sessions(scenes, tmp_path, "plain")
    port.handle("renderer deferred")
    port.handle("frames 2")
    assert port._deferred.frame_count == 2
    first = _image(port.out_path)
    port.handle("w 0.5")  # camera move -> TAA history reset
    assert port._deferred.frame_count == 0
    port.handle("frames 0")
    assert port._deferred.frame_count == 1
    assert not np.array_equal(_image(port.out_path), first)
    port.handle("renderer nonsense")
    assert port.mode == "deferred"


def test_viewer_main_runs_a_script(tmp_path, capsys):
    """The CLI on a procedural scene with a command file, on the CPU."""
    script = tmp_path / "cmds.txt"
    script.write_text("# a comment\n\nspp 2\nframes 1\nrenderer deferred\nframes 1\nquit\n"
                      "frames 5\n")
    out = tmp_path / "view.png"
    assert pviewer.main(["procedural:courtyard:2", "-o", str(out), "--width", "16",
                         "--height", "12", "--engine", "plain", "--device", "cpu",
                         "--script", str(script)]) == 0
    text = capsys.readouterr().out
    assert "triangles; writing" in text and "[1/2 spp" in text and "[deferred frame 1]" in text
    assert "scene load: " in text and " tree_depth=" in text
    assert read_png(out).shape == (12, 16, 3)
