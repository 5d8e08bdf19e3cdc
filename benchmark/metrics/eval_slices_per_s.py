"""Query slices scored by the ``run_eval`` calls of the window over those
calls' wall time, the fold's load included (host clock)."""


def read(m):
    if m.mix["driver"] != "eval" or m.window_s <= 0:
        return None
    return m.slices / m.window_s
