"""The port runs without JAX and without the JAX package: the machine with
the GPU has no JAX, and the port keeps its own copies of what it needs.

A subprocess blocks `jax` and `rayfinder_tpu`, imports every module of
rayfinder_tpu_torch and chip_smoke, reads the port's data files and builds a
scene, and fails if any file under rayfinder_tpu/ was opened. A static check
keeps JAX and JAX-package imports, library stand-ins for the kernels and
fallbacks around kernel launches out of the package.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "rayfinder_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_without_jax():
    mods = list(_modules()) + ["chip_smoke"]
    for m in ("ops.regen", "ops.regen_shaded", "ops.regen_segs", "render.shade", "ops.counted",
              "ops.slab", "ops.skyround", "prof.diag_iters", "scene.procedural", "io.ptformat",
              "render.renderer", "tools.sky_demo", "utils.math", "utils.image",
              "render.deferred", "render.fly_camera", "utils.profiling", "sky.solar",
              "tools.viewer", "tools.render", "tools.turntable", "tools.bvh_visualizer",
              "tools.pt_format_tool", "tools.textractor", "tools.sun_integrator",
              "render.wavefront", "parallel.sharding", "tools.blue_noise_tool",
              "tools.make_test_glb", "tools.bake_assets", "bench", "tools.make_quality_goldens",
              "ops.deferred"):
        assert f"rayfinder_tpu_torch.{m}" in mods
    code = (
        "import os, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rayfinder_tpu'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"banned = os.path.join({str(ROOT)!r}, 'rayfinder_tpu') + os.sep\n"
        "opened = []\n"
        "def hook(event, args):\n"
        "    if event == 'open' and isinstance(args[0], (str, bytes, os.PathLike)):\n"
        "        path = os.path.abspath(os.fsdecode(args[0]))\n"
        "        if path.startswith(banned):\n"
        "            opened.append(path)\n"
        "sys.addaudithook(hook)\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from rayfinder_tpu_torch.render.rng import blue_noise_tile\n"
        "from rayfinder_tpu_torch.sky.solar import solar_disk_radiance\n"
        "solar_disk_radiance(2.0, 0.001, 0.5, 560.0)\n"
        "from rayfinder_tpu_torch.render.scene import build_device_scene\n"
        "from rayfinder_tpu_torch.scene.procedural import courtyard_scene\n"
        "from rayfinder_tpu_torch.sky.model import sky_state_from_ui\n"
        "blue_noise_tile()\n"
        "sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)\n"
        "flat, textures = courtyard_scene(2, textured=True)\n"
        "build_device_scene(flat, textures=textures, device='cpu')\n"
        "assert not opened, opened\n"
        "assert not any(k.split('.')[0] in ('jax', 'rayfinder_tpu') for k, v in sys.modules.items() if v)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_package_sources_hold_no_stand_ins():
    """No JAX, no torch.compile or fused library operator in place of a
    kernel, and no try: (a launch that fails must raise, never fall back)."""
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert any(p.suffix == ".cu" for p in files)
    for path in files + [ROOT / "chip_smoke.py"]:
        text = path.read_text()
        for banned in ("import jax", "from jax", "torch.compile", "scaled_dot_product_attention"):
            assert banned not in text, f"{path.name}: {banned}"
        if path.suffix == ".py" and path.parent != ROOT:
            assert "try:" not in text, f"{path.name}: try around a launch"


def test_package_imports_nothing_of_the_jax_package():
    """No import of rayfinder_tpu and no path built into its directory, in
    the package or in chip_smoke.py."""
    for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                names = []
            for name in names:
                assert name.split(".")[0] != "rayfinder_tpu", f"{path.name}: imports {name}"
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert node.value.strip("/") != "rayfinder_tpu", f"{path.name}: path into it"


def test_kernel_sources_use_no_fast_math():
    """IEEE rounding in every kernel: no fast-math intrinsics, no
    use_fast_math (the kernels are held bit for bit to their plain
    versions)."""
    sources = sorted((PKG / "csrc").glob("*.cu*"))
    assert {p.name for p in sources} >= {"regen_shaded.cu", "regen_segs.cu", "path.cuh",
                                         "shade.cuh"}
    for path in sources:
        text = path.read_text()
        for banned in ("__powf", "__sinf", "__cosf", "__expf", "__logf", "__fdividef",
                       "use_fast_math"):
            assert banned not in text, f"{path.name}: {banned}"


def test_build_flags_keep_ieee_rounding():
    from rayfinder_tpu_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "--fmad=false" in flags and "arch=compute_90a,code=sm_90a" in flags
    assert "fast-math" not in flags and "fast_math" not in flags
    assert set(_build.SOURCES) | set(_build.HEADERS) == {
        p.name for p in (PKG / "csrc").iterdir() if p.suffix in (".cu", ".cuh")}


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    """A change to any source gives the library a new name, so a stale
    build is never loaded."""
    from rayfinder_tpu_torch.ops import _build

    before = _build.library_path()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in _build.SOURCES + _build.HEADERS:
        (csrc / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.library_path() == before
    (csrc / "regen.cu").write_text((csrc / "regen.cu").read_text() + "\n")
    assert _build.library_path() != before


def test_check_rejects_mismatched_tensors():
    from rayfinder_tpu_torch.ops._build import check

    dev = torch.device("cpu")
    check(torch.zeros(4, 3), "x", torch.float32, (4, 3), dev)
    with pytest.raises(TypeError, match="dtype"):
        check(torch.zeros(4, 3, dtype=torch.float64), "x", torch.float32, (4, 3), dev)
    with pytest.raises(ValueError, match="shape"):
        check(torch.zeros(4, 2), "x", torch.float32, (4, 3), dev)
    with pytest.raises(ValueError, match="contiguous"):
        check(torch.zeros(3, 4).t(), "x", torch.float32, (4, 3), dev)
    with pytest.raises(ValueError, match="on cpu"):
        check(torch.zeros(4, 3), "x", torch.float32, (4, 3), torch.device("meta"))


def test_chip_smoke_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
