"""A configuration's encoders, found by name: the ``family`` key of its
``coarse`` and ``sam`` sections names ``benchmark/families/<family>.py``
under the benchmark's root.  A family file gives, for the section it is
named in (plain ``torch``, float32, nothing of the program):

* ``keys(sec, prefix)``: the published state-dict layout, ``(key, shape,
  role)`` in order (the weights are views of one buffer in this order);
* ``forward(w, x, sec)``: the encoder's float32 output on (B, 3, H, W),
  TF32 off, ``w`` holding the keys without the prefix;
* ``flops(sec)``: one image's model FLOP by stage;
* ``tokens(sec)``: the real tokens of the sequence (a coarse encoder's,
  for the K2 roofline).

A family file may import another's helpers (``from benchmark.families
import dinov2``)."""

from __future__ import annotations

import pathlib

from benchmark.harness import traffic

ROOT = pathlib.Path(__file__).resolve().parents[2]


def load(sec: dict, root: pathlib.Path = ROOT):
    """The family module of configuration section ``sec``."""
    path = root / "benchmark" / "families" / f"{sec['family']}.py"
    return traffic.load(path, "bench_family")
