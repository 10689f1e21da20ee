"""Device ms per frame of every other device operation of the deferred frame
(the torch shade, the resolve, the copies), summed over the traced window."""

WALK_KERNELS = ("closest_kernel", "any_kernel")


def read(run):
    tr = run.trace
    if tr is None or not run.frames:
        return None
    other = [e - s for n, s, e in tr.in_window() if not any(k in n for k in WALK_KERNELS)]
    if not other:
        return None
    return 1e3 * sum(other) / len(run.frames)
