"""Share of the window's ``run_eval`` wall time inside the program's
``eval.load_fold`` spans, in percent: the fold's load (NIfTI reads,
decompression, resize and normalisation, the slice records).

The spans are the program's own (``protosam_tpu_torch/utils/
profiling.py``): its ``eval.run`` spans that lie inside the window's calls
(``m.call_spans``, the same ``perf_counter`` clock) are kept, with the
spans of their requests, so the profiled tail after the window is left
out.  None where the program keeps no such spans (before it had a
tracer), or where its ring overwrote spans of the kept calls.  The other
``eval_*`` readers of the program's spans use ``_runs`` and ``share``."""

NAMES = ("eval.load_fold",)


def _runs(m):
    """(the program's spans, its ``eval.run`` spans that lie inside the
    window's calls, those calls' wall in ns), or None where it keeps no
    such spans or its ring dropped some of theirs."""
    if m.mix["driver"] != "eval" or not m.call_spans:
        return None
    try:
        from protosam_tpu_torch.utils import profiling
        spans = profiling.spans()
        dropped = profiling.dropped()
    except (ImportError, AttributeError):
        return None
    calls = [(a * 1e9, b * 1e9) for a, b in m.call_spans]
    runs, wall = [], 0.0
    for a, b in calls:
        inside = [s for s in spans if s.name == "eval.run"
                  and a <= s.start and s.end <= b]
        if inside:
            runs += inside
            wall += b - a
    if not runs:
        return None
    # the ring drops the oldest spans: every span that ended after the
    # oldest kept one ended is still there
    if dropped and min(spans, key=lambda s: s.seq).end >= min(
            r.start for r in runs):
        return None
    return spans, runs, wall


def share(m, names):
    """Percent of the kept calls' wall inside the spans named ``names``
    of their requests, or None."""
    found = _runs(m)
    if found is None:
        return None
    spans, runs, wall = found
    requests = {r.request for r in runs}
    inside = sum(s.end - s.start for s in spans
                 if s.name in names and s.request in requests)
    return 100.0 * inside / wall


def read(m):
    return share(m, NAMES)
