"""The share of the study's day loop in which nothing runs on the device,
at the loop's untraced pace: 1 - the device's busy time inside the profiled
study's ``run.days`` span (the union of its operations, from the trace)
over the mean untraced day loop (``run_wall_s`` of the window's other
studies). Under the profiler each launch costs the host more, so the
profiled loop's own length holds idle that the untraced loop has not, and
is not the denominator."""


def read(run):
    t = run["trace"]
    if run["kind"] != "study" or t is None or not t.device or len(run["studies"]) < 2:
        return None
    loops = [(s, e) for s, e, name in t.host if name == "run.days"]
    if not loops or loops[0][1] <= loops[0][0]:
        return None
    lo, hi = loops[0]
    busy, cur_s, cur_e = 0, None, None
    for s, e, _ in t.device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    untraced = run["studies"][1:]
    loop_s = sum(p["run_wall_s"] for p in untraced) / len(untraced)
    return 1.0 - busy / 1e9 / loop_s
