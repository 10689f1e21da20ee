"""Device operations (kernels, copies, fills) in the traced window per frame
completed in it."""


def read(run):
    tr = run.trace
    if tr is None or not run.frames:
        return None
    return len(tr.in_window()) / len(run.frames)
