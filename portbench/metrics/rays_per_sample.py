"""Closest-hit and shadow rays the program traced in the window (its exact
counter, Renderer(count_rays=True)) over the pixel samples completed."""


def read(run):
    samples = sum(f["samples"] for f in run.frames)
    if run.rays is None or samples == 0:
        return None
    return run.rays / samples
