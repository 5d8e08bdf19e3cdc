"""Share of the ``run_eval`` calls' wall time outside the spans around
``forward_volume`` (each ended by a synchronize, as the call's copy of the
masks to the host ends it): the evaluation driver's host work, in
percent."""


def read(m):
    if m.mix["driver"] != "eval" or not m.call_spans:
        return None
    calls = sum(b - a for a, b in m.call_spans)
    inside = sum(b - a for a, b in m.host_spans)
    if calls <= 0 or not m.host_spans:
        return None
    return 100.0 * (1.0 - inside / calls)
