"""The device's idle share of the traced window, in %: 100 x (1 - the
merged intervals of kernels, copies and fills over the window's length)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
