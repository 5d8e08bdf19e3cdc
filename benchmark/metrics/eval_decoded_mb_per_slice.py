"""Megabytes (10^6 bytes) the fold's files decompress to, a slice scored:
the ``bytes_decoded`` counts on the program's ``eval.load_fold`` spans
over the ``slices`` on its ``eval.run`` spans
(``protosam_tpu_torch/utils/profiling.py``), kept as ``eval_load_share``
keeps them: the runs inside the window's calls, not the profiled tail.
None where the program keeps no such spans (before it had a tracer)."""

from benchmark.metrics.eval_load_share import _runs


def read(m):
    found = _runs(m)
    if found is None:
        return None
    spans, runs, _ = found
    requests = {r.request for r in runs}
    decoded = sum(s.attrs.get("bytes_decoded", 0) for s in spans
                  if s.name == "eval.load_fold" and s.request in requests)
    slices = sum(r.attrs.get("slices", 0) for r in runs)
    if not slices:
        return None
    return decoded / 1e6 / slices
