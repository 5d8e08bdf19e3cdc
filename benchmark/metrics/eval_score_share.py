"""Share of the window's ``run_eval`` wall time inside the program's
``eval.score`` and ``eval.detection`` spans, in percent: each slice's
Dice, IoU, precision, recall and boxes, and the detection table.  The
spans are kept as ``eval_load_share`` keeps them."""

from benchmark.metrics.eval_load_share import share

NAMES = ("eval.score", "eval.detection")


def read(m):
    return share(m, NAMES)
