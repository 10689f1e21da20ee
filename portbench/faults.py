"""Faults planted underneath the timed path, to show that the check catches
each fault a cell can have (one card: no exchange between chips to leave
out):

- `unchanged`: the step returns its state unchanged (the path tracer's
  dispatch hands back its accumulation; the deferred frame resolves its
  history with itself);
- `half`: half of the step's work left out and the mean taken over the rest
  (the path tracer's dispatch traces half of its samples and counts each
  twice; the deferred frame's odd rows of lighting take the even rows');
- `altered`: the answer altered where it is made (each new sample, or each
  lighting value, 25% brighter).

    with faults.planted("pt", "half"):
        line = harness.execute(...)

The tests plant them on the CPU at a tiny size; tools/readings.py --faults
reads them on the card at the cell's own size.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def _patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _pt(fault: str):
    from rayfinder_tpu_torch.render import pathtracer, renderer

    real = pathtracer.accumulate_samples_regen

    def broken(scene, sky, camera, tile, frame, accum, *, num_frames, **kw):
        if fault == "unchanged":
            real(scene, sky, camera, tile, frame, accum, num_frames=num_frames, **kw)
            return accum
        if fault == "half":
            kept = max(1, num_frames // 2)
            out = real(scene, sky, camera, tile, frame, accum, num_frames=kept, **kw)
            return accum + (out - accum) * (num_frames / kept)
        out = real(scene, sky, camera, tile, frame, accum, num_frames=num_frames, **kw)
        return accum + 1.25 * (out - accum)

    return _patched(renderer, "pick_accumulator", lambda scene, engine: broken)


def _deferred(fault: str):
    from rayfinder_tpu_torch.render import deferred

    if fault == "unchanged":
        def frame(scene, sky, camera, accum, frame_count, exposure, **kw):
            return deferred.resolve_pass(accum, accum, 0, exposure)

        return _patched(deferred, "frame_pass", frame)
    real = deferred.lighting_pass

    def lighting(*args, **kw):
        out = real(*args, **kw)
        if fault == "half":
            out = out.clone()
            out[1::2] = out[0::2][: out[1::2].shape[0]]
            return out
        return 1.25 * out

    return _patched(deferred, "lighting_pass", lighting)


def planted(renderer: str, fault: str):
    """A context in which the program's `renderer` ("pt" or "deferred")
    carries `fault`."""
    if fault not in FAULTS:
        raise KeyError(f"no fault {fault!r}: {FAULTS}")
    return {"pt": _pt, "deferred": _deferred}[renderer](fault)
