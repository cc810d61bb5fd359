"""Milliseconds per simulated day of a whole study batch in ``api.run``'s
eager day loop: the sum of ``run_wall_s`` over the sum of days (the
profiled study left out when others ran)."""


def read(run):
    if run["kind"] != "study":
        return None
    studies = run["studies"][1:] if run["trace"] is not None and len(run["studies"]) > 1 \
        else run["studies"]
    return 1e3 * sum(p["run_wall_s"] for p in studies) / (run["days"] * len(studies))
