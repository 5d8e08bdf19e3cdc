"""K2 (``csrc/packed_attention.cu``, DINOv2's packed masked attention):
the least time the card could take for each launch in the traced tail,
at that launch's shape (``roofline.kernel_cost``), summed, over the summed
device time of those launches, in percent.  A launch's shape is the
coarse encoder's at the batch of the ``get_features`` span that launched
it, its real tokens the encoder family's ``tokens``; kernels are found by
name."""

import re

from benchmark.harness import family, roofline

PATTERNS = ("packed_kernel",)
SPAN = re.compile(r"bench\.coarse/get_features\[b=(\d+)\]")


def read(m):
    if m.mix["driver"] != "volumes" or m.trace is None:
        return None
    c = m.cfg["coarse"]
    n_tokens = family.load(c, m.root).tokens(c)
    bound = dur = 0.0
    for op in m.trace.ops:
        if op.cat != "kernel" or not any(p in op.name for p in PATTERNS):
            continue
        hit = SPAN.fullmatch(op.span.name) if op.span else None
        if not hit:
            continue
        _, _, ms, _ = roofline.kernel_cost(
            "packed_masked_attention", b=int(hit.group(1)),
            s=roofline.dino_seq(n_tokens), nh=c["num_heads"],
            hd=c["embed_dim"] // c["num_heads"], n_valid=n_tokens)
        bound += ms * 1e3
        dur += op.dur
    return 100.0 * bound / dur if dur else None
