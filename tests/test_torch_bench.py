"""The port's courtyard bench (rayfinder_tpu_torch/bench.py) on the CPU, small:
courtyard_scene(2, textured=True) through GLB -> .pt (cached in tmp_path),
32x32, 2 bounces, two 2-sample dispatches on the plain versions, the
1024-spp time at 32x16, the quality gate against a golden written to
tmp_path, and the traversal-efficiency fields. On the card it runs at its
defaults (512x512, 4 bounces, 16-sample dispatches, 1920x1080) against
tests/goldens/quality_courtyard_512x512_32spp.npz (chip_smoke.py phase 12).
"""

import json

import numpy as np
import pytest

from rayfinder_tpu_torch import bench
from rayfinder_tpu_torch.prof import scenes
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.sky.model import sky_state_from_ui
from rayfinder_tpu_torch.tools.make_quality_goldens import quality_image

SMALL = dict(scale=2, width=32, height=32, num_bounces=2, num_frames=2, device="cpu",
             engine="plain", hd_width=32, hd_height=16, hd_frames=2)
ARGV = ["--scale", "2", "--width", "32", "--height", "32", "--bounces", "2", "--frames", "2",
        "--device", "cpu", "--engine", "plain", "--hd-width", "32", "--hd-height", "16",
        "--hd-frames", "2"]
WASTE = [f"mt_waste_{lane}{pop}" for lane in ("", "lane_")
         for pop in ("primary", "bounce1", "bounce2")]
GATE = ["quality_rmse_off_wrap", "wrap_pixels", "quality_rmse_wrap", "wrap_mean_diff",
        "wrap_mean_se"]


@pytest.fixture
def golden(monkeypatch, tmp_path):
    """The .pt cache in tmp_path, and a golden there: quality_image on the
    same .pt scene, stored as float16 like the committed goldens."""
    monkeypatch.setattr(scenes, "CACHE_DIR", tmp_path)
    scene, _ = scenes.courtyard_pt_scene(2, device="cpu", textured=True)
    img = quality_image(scene, sky_state_from_ui(*scenes.BENCH_SKY),
                        create_camera(*scenes.BENCH_CAMERA, 1.0), width=32, height=32,
                        num_frames=2, num_bounces=2, engine="plain")
    path = tmp_path / "golden.npz"
    np.savez_compressed(path, image=img.astype(np.float16))
    return path


def _lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_bench_lines(golden, capsys):
    last = bench.courtyard_bench(golden=golden, **SMALL)
    first, second = _lines(capsys.readouterr().out)
    assert second == last
    assert list(first) == ["metric", "value", "unit", "time_to_1024spp_1080p_s", "rays",
                           "device"]
    assert first["metric"] == "courtyard_512x512_4bounce_path_trace"
    assert first["unit"] == "Mrays/s/chip" and first["device"] == "cpu"
    assert isinstance(first["value"], float) and first["value"] > 0
    assert isinstance(first["time_to_1024spp_1080p_s"], float)
    assert first["time_to_1024spp_1080p_s"] > 0
    closest, shadow = first["rays"]
    assert closest >= 32 * 32 * 2 and 0 < shadow <= closest  # every sample traces a segment
    # The last line is the first with the gate and the efficiency folded in.
    assert {k: last[k] for k in first} == first
    assert set(last) - set(first) == {"quality_rmse", "quality_ok", *GATE, *WASTE}
    assert last["quality_ok"] is True
    assert 0 <= last["quality_rmse"] < 1e-3  # the golden's float16 rounding alone
    assert 0 <= last["quality_rmse_off_wrap"] < 1e-3
    assert isinstance(last["wrap_pixels"], int) and 0 <= last["wrap_pixels"] < 32 * 32
    assert len(last["wrap_mean_diff"]) == len(last["wrap_mean_se"]) == 3
    for key in WASTE:
        assert isinstance(last[key], float) and 0 <= last[key] < 100, key
    for pop in ("primary", "bounce1", "bounce2"):  # a warp issues at least its lanes' tests
        assert last[f"mt_waste_{pop}"] >= last[f"mt_waste_lane_{pop}"]


def test_bench_cli_fails_on_a_far_golden(golden, tmp_path, capsys):
    assert bench.main([*ARGV, "--golden", str(golden)]) == 0
    far = tmp_path / "far.npz"
    with np.load(golden) as data:
        np.savez_compressed(far, image=(1.0 - data["image"].astype(np.float32)).astype(
            np.float16))
    capsys.readouterr()
    assert bench.main([*ARGV, "--golden", str(far)]) == 1
    captured = capsys.readouterr()
    last = _lines(captured.out)[-1]  # the line is printed before the exit
    assert last["quality_ok"] is False and last["quality_rmse"] > 1e-3
    assert "quality gate failed" in captured.err


def test_bench_gate_cannot_run_without_its_golden(golden, tmp_path):
    """A golden that is missing or of another size raises: the gate never
    passes by not running."""
    with pytest.raises(FileNotFoundError):
        bench.courtyard_bench(golden=tmp_path / "missing.npz", **SMALL)
    with pytest.raises(ValueError, match="golden"):
        bench.courtyard_bench(golden=golden, **{**SMALL, "width": 16})
