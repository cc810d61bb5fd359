"""The share of the profiled study's wall time in which nothing ran on the
device."""


def read(run):
    t = run["trace"]
    if run["kind"] != "study" or t is None or t.window_s <= 0 or not t.device:
        return None
    return 1.0 - t.busy_s() / t.window_s
