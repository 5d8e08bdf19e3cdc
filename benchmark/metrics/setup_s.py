"""Seconds from the process's start to the window's: imports, weights made
on the card, the build, the fold where the traffic writes one, and the
warm-up (host clock).  A checkout's first run also builds the kernels."""


def read(m):
    return m.setup_s
