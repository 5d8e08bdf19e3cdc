"""Device milliseconds a query slice in the prompts layer: CUDA events on
the stream around its entry points (``harness/probe.py``) summed over
the window, over the real slices (support encodes and padded slices are
part of the layer's work)."""

LAYER = "prompts"


def read(m):
    if m.mix["driver"] != "volumes" or LAYER not in m.layer_ms \
            or not m.slices:
        return None
    return m.layer_ms[LAYER] / m.slices
