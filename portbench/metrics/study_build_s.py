"""Seconds of a study spent outside its day loop: the batch, week and core
builds and the finalize (``api.run``'s ``wall_s - run_wall_s``), the mean
over the window's studies (the profiled one left out when others ran)."""


def read(run):
    if run["kind"] != "study":
        return None
    studies = run["studies"][1:] if run["trace"] is not None and len(run["studies"]) > 1 \
        else run["studies"]
    return sum(p["wall_s"] - p["run_wall_s"] for p in studies) / len(studies)
