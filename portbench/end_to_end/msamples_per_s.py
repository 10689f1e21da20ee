"""Pixel samples completed in the window over the window's seconds, in
millions: every frame's work (readbacks and pass restarts included) over all
the time from the first frame's start to the last frame's end."""

from portbench import window


def read(run):
    return window.rate(run.frames) / 1e6
