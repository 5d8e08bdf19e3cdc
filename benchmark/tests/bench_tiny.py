"""A test-size benchmark root: the harness's drivers, metrics and model
families with the tiny configuration, mixes and limits of ``tests/tiny``,
run on the CPU with the program's plain kernels and SAM at a 256 frame."""

from __future__ import annotations

import pathlib
import shutil
import time

from benchmark.harness import cell

REPO = pathlib.Path(__file__).resolve().parents[2]
TINY = pathlib.Path(__file__).resolve().parent / "tiny"


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    root = tmp / "root"
    (root / "benchmark").mkdir(parents=True)
    for sub in ("drivers", "metrics", "families"):
        shutil.copytree(REPO / "benchmark" / sub, root / "benchmark" / sub)
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(TINY / sub, root / "benchmark" / sub)
    shutil.copy(TINY / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def run(monkeypatch, root, name, seed=5, variant=None, hooks=None,
        seconds=0.01):
    """One tiny run on the CPU: (result, lines, earlier)."""
    from protosam_tpu_torch.eval import protosam_eval

    monkeypatch.setattr(protosam_eval, "SAM_IMAGE_SIZE", 256)
    return cell.run(name, seed, seconds, False, time.perf_counter(),
                    device="cpu", variant=variant, root=root, hooks=hooks)
