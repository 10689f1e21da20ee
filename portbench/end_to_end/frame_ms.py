"""The window over the frames it completed, in ms; a frame ends when its
image is on the host."""

from portbench import window


def read(run):
    return window.mean_frame_s(run.frames) * 1e3
