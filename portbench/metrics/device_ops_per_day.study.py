"""Operations on the device (kernels, copies, fills) per simulated day,
from the profiler over the window's first study, whole."""


def read(run):
    if run["kind"] != "study" or run["trace"] is None or not run["trace"].device:
        return None
    return len(run["trace"].device) / run["days"]
