"""Query slices ``forward_volume`` segmented in the window over the
window's seconds, all calls and all time (host clock)."""


def read(m):
    if m.mix["driver"] != "volumes" or m.window_s <= 0:
        return None
    return m.slices / m.window_s
