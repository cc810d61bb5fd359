"""Host seconds of the profiled study's week build: the program's ``week``
span (occupancy packing, the block schedules, the stack, the person-slot
table and the upload) on the profiler's host timeline, over the study's
builds (one a run)."""


def read(run):
    t = run["trace"]
    if run["kind"] != "study" or t is None:
        return None
    weeks = [e - s for s, e, name in t.host if name == "week"]
    return sum(weeks) / 1e9 if weeks else None
