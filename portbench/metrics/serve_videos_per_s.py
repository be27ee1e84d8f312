"""serve_videos_per_s: the videos answered within the window, over the
window's seconds (host clock)."""


def read(run):
    if run.kind != "serve":
        return None
    done = sum(1 for r in run.records if "events" in r and r["done"] <= run.t_end)
    return done / run.seconds
