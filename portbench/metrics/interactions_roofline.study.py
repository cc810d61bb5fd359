"""The interaction kernel's share of its roofline over the profiled study,
in percent: the least time the problem needs (``portbench/roofline.py``:
each day's visits and the susceptible-infectious pairs the reference
counted for every scenario of that study) over the device time of the
kernel's launches."""

from portbench import roofline


def read(run):
    t = run["trace"]
    if run["kind"] != "study" or t is None or "traced_pairs" not in run:
        return None
    kernel = sum(e - s for s, e, _ in t.ops("interactions_kernel")) / 1e9
    if kernel <= 0:
        return None
    pairs, visits, B = run["traced_pairs"], run["visits"], run["scenarios"]
    least = sum(roofline.least_seconds(roofline.launch_bytes(visits[d % 7], B),
                                       float(pairs[d].sum()))
                for d in range(run["days"]))
    return 100.0 * least / kernel
