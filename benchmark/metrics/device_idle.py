"""Share of the traced tail (volumes) with no kernel, copy or memset
running on the card, in percent."""

DRIVER = "volumes"


def read(m):
    if m.mix["driver"] != DRIVER or m.trace is None or not m.trace.window_us:
        return None
    return 100.0 * (1.0 - m.trace.busy_us / m.trace.window_us)
