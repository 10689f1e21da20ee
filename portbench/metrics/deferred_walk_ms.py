"""Device ms per frame of the deferred frame's BVH walks: the closest-hit
kernel K1 and the any-hit kernel K2 (csrc/walk.cu closest_kernel,
any_kernel), summed over the traced window."""

WALK_KERNELS = ("closest_kernel", "any_kernel")


def read(run):
    tr = run.trace
    if tr is None or not run.frames:
        return None
    walk = [e - s for n, s, e in tr.in_window() if any(k in n for k in WALK_KERNELS)]
    if not walk:
        return None
    return 1e3 * sum(walk) / len(run.frames)
