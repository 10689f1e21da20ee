"""Whether the timed path's frames are right: the display bytes the program
put on the host at the check's pixels, frame by frame, against the
reference's for the same pixels, poses and frame indices.

The number compared is the root mean square of the byte differences over
every compared value (frames x pixels x channels). A sample whose path meets
a different triangle in the two (two triangles at one distance) moves its
pixel's byte by up to its whole weight, so a sound run reads above 0; a
step that returns its state unchanged, half of a dispatch left out or a
sample altered where it is made moves every frame. Each cell's limit and the
readings it was set from are in limits/<cell>.json.
"""

from __future__ import annotations

import numpy as np


def numbers(program: np.ndarray, reference: np.ndarray) -> dict:
    """The compared numbers of (F, P, 3) bytes against the reference's."""
    if program.shape != reference.shape:
        raise ValueError(f"{program.shape} frames against a reference of {reference.shape}")
    d = program.astype(np.float64) - reference.astype(np.float64)
    return {"rmse_u8": float(np.sqrt(np.mean(d * d)))}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct iff every number is at
    most its limit."""
    out = {name: {"value": values[name], "limit": limits[name]["limit"]} for name in values}
    return all(v["value"] <= v["limit"] for v in out.values()), out
