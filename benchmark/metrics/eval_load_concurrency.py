"""How many of the fold's load steps run at once, on average: the summed
seconds of the program's ``data.*`` spans (decode, preprocess, labels,
index) over the summed seconds of the ``eval.load_fold`` spans around
them, in the requests of the runs ``eval_load_share`` keeps (the window's
calls, not the profiled tail).  About 1 where the scans load one after
another on one thread; up to the number of scans where they load on a
pool.  None where ``eval_load_share._runs`` finds nothing (no tracer in
the program, or spans of a kept call dropped)."""

from benchmark.metrics.eval_load_share import _runs


def read(m):
    found = _runs(m)
    if found is None:
        return None
    spans, runs, _ = found
    requests = {r.request for r in runs}
    steps = load = 0
    for s in spans:
        if s.request not in requests:
            continue
        if s.name.startswith("data."):
            steps += s.end - s.start
        elif s.name == "eval.load_fold":
            load += s.end - s.start
    if not load:
        return None
    return steps / load
