"""idle_share: 1 minus the union of the device's operations over the
profiled slice, in %; device."""


def read(view):
    sl = view.slice
    if sl is None or sl.window_s <= 0 or not sl.ops:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
