"""Share of the window's ``run_eval`` wall time inside the program's
``eval.support``, ``eval.gather_queries`` and ``eval.to_device`` spans, in
percent: picking the support, building the query chunks and copying them
to the card.  The spans are kept as ``eval_load_share`` keeps them."""

from benchmark.metrics.eval_load_share import share

NAMES = ("eval.support", "eval.gather_queries", "eval.to_device")


def read(m):
    return share(m, NAMES)
