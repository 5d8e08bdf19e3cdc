"""Model FLOPs of the window's work over the window's seconds at the
card's published bf16 peak, in percent: the coarse encoder and SAM's
stages per real slice plus one support encode per volume
(``harness/roofline.slice_flops``), whatever kernels run them."""

from benchmark.harness import roofline


def read(m):
    if m.mix["driver"] != "volumes" or m.window_s <= 0 or not m.slices:
        return None
    dino, sam = roofline.slice_flops(m.cfg, m.root)
    flops = m.slices * (dino + sam) + m.calls * dino
    return 100.0 * flops / (m.window_s * roofline.PEAK_BF16)
