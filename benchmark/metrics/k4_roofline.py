"""K4 (``csrc/relpos_attention.cu``, SAM's windowed and global rel-pos
attention): as ``k2_roofline``.  Within one ``encode_image`` span the
launches run block by block, so the j-th is block j's, global or
windowed by the configuration; a span whose launch count is not the
encoder's depth is left out."""

import collections
import re

from benchmark.harness import roofline

PATTERNS = ("relpos_kernel",)
SPAN = re.compile(r"bench\.sam_encoder/encode_image\[b=(\d+)\]")


def read(m):
    if m.mix["driver"] != "volumes" or m.trace is None:
        return None
    s = m.cfg["sam"]
    g, win = s["image_size"] // s["patch_size"], s["window_size"]
    hd = s["embed_dim"] // s["num_heads"]
    by_span = collections.defaultdict(list)
    for op in m.trace.ops:
        if op.cat != "kernel" or not any(p in op.name for p in PATTERNS):
            continue
        hit = SPAN.fullmatch(op.span.name) if op.span else None
        if hit:
            by_span[(op.span.index, int(hit.group(1)))].append(op)
    bound = dur = 0.0
    for (_, b), ops in by_span.items():
        if len(ops) != s["depth"]:
            continue
        for j, op in enumerate(sorted(ops, key=lambda o: o.start)):
            if j in s["global_attn_indexes"]:
                side, patch = g, g
            else:
                side, patch = -(-g // win) * win, win
            _, _, ms, _ = roofline.kernel_cost(
                "relpos_patch_attention", b=b, hp=side, wp=side,
                nh=s["num_heads"], hd=hd, patch=patch)
            bound += ms * 1e3
            dur += op.dur
    return 100.0 * bound / dur if dur else None
