"""Process start up to the first timed frame: imports, CUDA's start, the
kernel library's load (its build on a checkout's first run), the `.pt`'s
load and upload (its writing on a first run), the renderer and its warm-up."""


def read(run):
    return run.setup_s
