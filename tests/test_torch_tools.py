"""The port's tools against the JAX package's on the CPU: the render and
turntable CLIs (--device cpu; JAX with engine="reference"), the BVH heat
map, the .pt converter, the texture extractor, the spectral solar model and
sun integrator (numpy float64 in both), and the PassTimer.

Images: RMSE < 5e-3 (tests/test_goldens.py); the heat map exactly but for
the named pixels, and its node counts on JAX's rays exactly; bytes equal;
f64 results at rtol 1e-12.
"""

import numpy as np
import pytest
import torch

from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu.sky import solar as jsolar
from rayfinder_tpu.tools import bvh_visualizer as jbvh
from rayfinder_tpu.tools import pt_format_tool as jpt_tool
from rayfinder_tpu.tools import render as jrender
from rayfinder_tpu.tools import sun_integrator as jsun
from rayfinder_tpu.tools import textractor as jtex
from rayfinder_tpu.tools import turntable as jturntable
from rayfinder_tpu.utils.profiling import PassTimer as JaxPassTimer
from rayfinder_tpu_torch.sky import solar
from rayfinder_tpu_torch.tools import bvh_visualizer, pt_format_tool, render, sun_integrator
from rayfinder_tpu_torch.tools import textractor, turntable
from rayfinder_tpu_torch.tools.export_glb import export_flattened_glb
from rayfinder_tpu_torch.utils.image import read_png, rmse
from rayfinder_tpu_torch.utils.profiling import PassTimer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small tensors run faster on one, and the
    tier-1 run shares the machine's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _png(path):
    return read_png(path).astype(np.float32) / 255.0


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    """courtyard_scene(4), textured, exported to a GLB by the port."""
    flat, textures = courtyard_scene(4, textured=True)
    path = tmp_path_factory.mktemp("scene") / "courtyard4.glb"
    export_flattened_glb(flat, textures, path)
    return path


def test_render_tool_matches_jax(tmp_path, capsys):
    """Auto-framed procedural courtyard, 32x24, 2 spp: the same image as
    JAX's tool, and the same printed lines."""
    args = ["procedural:courtyard:4", "--width", "32", "--height", "24", "--spp", "2",
            "--bounces", "2", "--sun-zenith", "35", "--sun-azimuth", "25"]
    assert jrender.main(args + ["-o", str(tmp_path / "jax.png"), "--engine", "reference"]) == 0
    assert render.main(args + ["-o", str(tmp_path / "port.png"), "--engine", "plain",
                               "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[3] and lines[0].startswith("scene: 6016 triangles")
    assert lines[1].startswith("rendered 32x24 @ 2spp") and "Mrays/s" in lines[4]
    assert rmse(_png(tmp_path / "port.png"), _png(tmp_path / "jax.png")) < 5e-3
    with pytest.raises(SystemExit):
        render.main(["procedural:duck"])


def test_render_tool_camera_flags(tmp_path):
    """An explicit camera, exposure and albedo: the same image as JAX's."""
    args = ["procedural:courtyard:2", "--width", "24", "--height", "16", "--spp", "2",
            "--camera-origin", "-16", "5", "0", "--camera-look-at", "12", "2", "0",
            "--exposure-stops", "1", "--albedo", "0.3", "0.3", "0.3", "--vfov", "60"]
    jrender.main(args + ["-o", str(tmp_path / "jax.png"), "--engine", "reference"])
    render.main(args + ["-o", str(tmp_path / "port.png"), "--engine", "reference",
                        "--device", "cpu"])
    assert rmse(_png(tmp_path / "port.png"), _png(tmp_path / "jax.png")) < 5e-3


def test_turntable_matches_jax(glb, tmp_path, capsys):
    args = [str(glb), "--frames", "2", "--width", "24", "--height", "16", "--spp", "2"]
    assert jturntable.main(args + ["--outdir", str(tmp_path / "jax"), "--engine",
                                   "reference"]) == 0
    assert turntable.main(args + ["--outdir", str(tmp_path / "port"), "--engine", "plain",
                                  "--device", "cpu"]) == 0
    for k in range(2):
        name = f"frame_{k:03d}.png"
        assert rmse(_png(tmp_path / "port" / name), _png(tmp_path / "jax" / name)) < 5e-3
    assert "frame: " in capsys.readouterr().out


# The camera rays of the two packages differ by an ulp or two in some
# directions: JAX's jnp.linalg.norm on the CPU may be
# sqrt(fma(z, z, fma(y, y, x * x))) where the port rounds each product, and
# torch's CPU sqrt is not rounded to nearest on every build and CPU. Which
# rays differ, and by how much, depends on the host (249 or 498 of the
# 3,072, by at most 1 or 2 ulps, seen so far); a heat-map pixel
# may differ only where its ray does and crosses a node box's edge there.
# On JAX's own rays the node counts are equal (below).
RAY_ULPS = 4


def test_bvh_heat_map_equals_jax(glb, tmp_path):
    """K1's node counts (its plain version here) are the plane walk's, so the
    heat map is JAX's but for pixels whose camera rays differ (by at most
    RAY_ULPS in each component), and equal to JAX's node counts on JAX's
    rays; the CLI writes it."""
    import jax.numpy as jnp

    from rayfinder_tpu.render.camera import generate_camera_ray as jax_ray
    from rayfinder_tpu.render.scene import load_device_scene as jax_load
    from rayfinder_tpu.render.traverse import intersect_closest as jax_closest
    from rayfinder_tpu_torch.ops.walk import intersect_closest_kernel
    from rayfinder_tpu_torch.render.camera import generate_camera_ray
    from rayfinder_tpu_torch.render.scene import load_device_scene

    w, h = 64, 48
    got = bvh_visualizer.visualize(glb, w, h, device="cpu")
    want = jbvh.visualize(glb, w, h)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3) and got.max() > got.min()
    differ = np.nonzero((got != want).any(axis=2).reshape(-1))[0].tolist()
    scene, jscene = load_device_scene(glb, device="cpu"), jax_load(glb)
    camera = bvh_visualizer.heat_camera(scene, w, h)
    u, v = bvh_visualizer.pixel_uv(w, h)
    jo, jd = (np.array(a) for a in jax_ray(camera, u, v))
    po, pd = (a.numpy() for a in generate_camera_ray(camera, torch.from_numpy(u),
                                                    torch.from_numpy(v)))
    assert np.array_equal(po, jo)
    ulps = np.abs(pd.view(np.int32).astype(np.int64) - jd.view(np.int32))
    assert ulps.max() <= RAY_ULPS
    assert set(differ) <= set(np.nonzero(ulps.max(axis=1) > 0)[0].tolist())
    out = tmp_path / "heat.png"
    assert bvh_visualizer.main([str(glb), "-o", str(out), "--width", str(w), "--height", str(h),
                                "--device", "cpu"]) == 0
    np.testing.assert_array_equal(read_png(out), got)
    # JAX's rays through K1's wrapper: JAX's node counts exactly.
    t_max = np.float32(np.finfo(np.float32).max)
    want_visits = np.asarray(jax_closest(jscene, jnp.asarray(jo), jnp.asarray(jd),
                                         jnp.float32(t_max))[3])
    visits = intersect_closest_kernel(scene, torch.from_numpy(jo), torch.from_numpy(jd),
                                      torch.full((w * h,), float(t_max)))[3]
    np.testing.assert_array_equal(visits.numpy(), want_visits)


def test_pt_format_tool_bytes_equal_jax(glb, tmp_path):
    assert jpt_tool.main([str(glb), "-o", str(tmp_path / "jax.pt")]) == 0
    assert pt_format_tool.main([str(glb), "-o", str(tmp_path / "port.pt")]) == 0
    assert (tmp_path / "port.pt").read_bytes() == (tmp_path / "jax.pt").read_bytes()


def test_textractor_pngs_equal_jax(glb, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert jtex.main([str(glb), "--outdir", str(tmp_path / "jax")]) == 0
    assert textractor.main([str(glb), "--outdir", str(tmp_path / "port")]) == 0
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) > 1 and names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        np.testing.assert_array_equal(read_png(tmp_path / "port" / name),
                                      read_png(tmp_path / "jax" / name))


@pytest.mark.parametrize("args", [(1.0, 0.0, 0.5, 560.0), (2.5, 0.002, 0.1, 333.0),
                                  (9.7, 0.004, 0.9, 720.0), (10.0, 0.0, 0.0, 320.0)])
def test_solar_disk_radiance_matches_jax(args):
    got, want = solar.solar_disk_radiance(*args), jsolar.solar_disk_radiance(*args)
    assert got == pytest.approx(want, rel=1e-12) and got > 0.0


def test_spectral_sky_matches_jax():
    got = solar.SpectralSkyState(np.radians(60.0), turbidity=3.0, albedo=0.5)
    want = jsolar.SpectralSkyState(np.radians(60.0), turbidity=3.0, albedo=0.5)
    np.testing.assert_allclose(got.configs, want.configs, rtol=1e-12)
    np.testing.assert_allclose(got.radiances, want.radiances, rtol=1e-12)
    for theta, gamma, wl in ((0.7, 0.1, 560.0), (1.2, 0.003, 400.0), (0.2, 2.5, 700.0)):
        assert got.solar_radiance(theta, gamma, wl) == pytest.approx(
            want.solar_radiance(theta, gamma, wl), rel=1e-12)
    waves = np.linspace(360, 700, 50)
    for ours, theirs in ((solar.cie1931_x, jsolar.cie1931_x), (solar.cie1931_y, jsolar.cie1931_y),
                         (solar.cie1931_z, jsolar.cie1931_z)):
        np.testing.assert_allclose(ours(waves), theirs(waves), rtol=1e-12)
    rad = np.linspace(1.0, 2.0, len(solar.WAVELENGTHS))
    np.testing.assert_allclose(solar.spectral_to_srgb(solar.WAVELENGTHS, rad),
                               jsolar.spectral_to_srgb(jsolar.WAVELENGTHS, rad), rtol=1e-12)


def test_sun_integrator_matches_jax(tmp_path, capsys):
    """At 12x12 pixels: the means and disks equal JAX's at rtol 1e-12; the
    CLI prints the three C arrays and writes the ten disk PNGs."""
    means, disks = sun_integrator.integrate_sun_disks(12)
    jmeans, jdisks = jsun.integrate_sun_disks(12)
    np.testing.assert_allclose(means, jmeans, rtol=1e-12)
    assert len(disks) == 10
    for a, b in zip(disks, jdisks):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    assert sun_integrator.main(["--size", "8", "--write-disks", "--outdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("const float solar_radiances_") == 3
    assert len(list(tmp_path.glob("sundisk-turbidity-*.png"))) == 10


def test_pass_timer_sections_and_report():
    timer = PassTimer(window=2)
    fence = torch.zeros(4)
    for _ in range(3):
        with timer.section("a", fence_value=fence):
            pass
    with timer.section("b"):
        sum(range(1000))
    avg = timer.averages_ms()
    assert list(avg) == ["a", "b"] and all(v >= 0.0 for v in avg.values())
    assert len(timer._durations["a"]) == 2  # the rolling window
    report = timer.report()
    assert report.startswith("a: ") and "  b: " in report and report.endswith("ms")
    # The same report format as the JAX package's.
    jt = JaxPassTimer()
    with jt.section("a"):
        pass
    assert jt.report().startswith("a: ") and jt.report().endswith("ms")
