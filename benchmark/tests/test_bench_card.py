"""A cell as committed, run on the card (marked ``cuda``; skips without
one): ``python -m pytest benchmark/tests -m cuda``."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import cell


@pytest.mark.cuda
def test_vitb_volumes_is_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res, lines, earlier = cell.run("l14_vitb.volumes", 2**31 + 99, 8.0,
                                   True, time.perf_counter())
    assert res["correct"], lines
    assert res["device"]["busy_s"] > 0
    assert 0 < res["metrics"]["pipeline_mfu"]["value"] < 100
