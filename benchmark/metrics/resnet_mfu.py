"""The ResNet coarse encoder's model FLOPs over the coarse layer's device
time, in percent of the card's published bf16 peak: the coarse family's
``flops`` of one image (``families/deeplab_r101.py``, convolutions only)
times the images the program's ``resnet.encode`` spans counted in the
window's volumes, over the probe's coarse device milliseconds of the
window (the encoder and ALP's scoring, ``harness/probe.py``).

The window's volumes are read as ``coarse_mfu.py`` reads them: the
``m.calls`` newest ``pipeline.volume`` spans before those of the traced
tail, and the images of the ``resnet.encode`` spans of their requests.
None where the program keeps no such spans (before it had them), where
its ring overwrote spans of the window, or without the probe's device
times."""

from benchmark.harness import family, roofline, traffic

SPAN = "resnet.encode"


def _window_images(m):
    """Images the window's volumes encoded, or None."""
    try:
        from protosam_tpu_torch.utils import profiling
        spans = profiling.spans()
        dropped = profiling.dropped()
    except (ImportError, AttributeError):
        return None
    volumes = [s for s in spans if s.name == "pipeline.volume"]
    tail = traffic.driver(m.mix, m.root).trace_calls \
        if m.trace is not None else 0
    end = len(volumes) - tail
    if end - m.calls < 0:
        return None
    window = volumes[end - m.calls:end]
    # the ring drops the oldest spans: every span that ended after the
    # oldest kept one ended is still there
    if dropped and min(spans, key=lambda s: s.seq).end >= window[0].start:
        return None
    requests = {v.request for v in window}
    images = sum(s.attrs.get("images", 0) for s in spans
                 if s.name == SPAN and s.request in requests)
    return images or None


def read(m):
    if m.mix["driver"] != "volumes" or not m.calls \
            or not m.layer_ms.get("coarse"):
        return None
    images = _window_images(m)
    if images is None:
        return None
    c = m.cfg["coarse"]
    flops = images * sum(family.load(c, m.root).flops(c).values())
    return 100.0 * flops / (m.layer_ms["coarse"] / 1e3 * roofline.PEAK_BF16)
