"""A cell cut to a size the CPU runs in seconds: courtyard(2), 32x24, the
program's plain engine, the caches in a temporary directory."""

from __future__ import annotations

from portbench import assets, cells


def tiny_cell(name: str, tmp_path, monkeypatch, pixels: int = 64):
    monkeypatch.setattr(assets, "CACHE", tmp_path / "cache")
    cell = cells.find(name)
    cfg = dict(cell.config, name="tiny_" + cell.config["renderer"], width=32, height=24,
               engine="plain", scene={"generator": "courtyard",
                                      "args": {"subdiv": 2, "textured": True}})
    mix = dict(cell.mix, check_pixels=pixels)
    if mix["kind"] == "converge":
        mix.update(spp=8, batch=4)
    return cell._replace(config=cfg, mix=mix)
