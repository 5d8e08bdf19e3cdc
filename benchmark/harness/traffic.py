"""The one traffic generator.  A mix is a data file,
``traffic/<name>.json``; its ``driver`` names the module
``benchmark/drivers/<driver>.py`` that sends its calls to the program, and
everything else in it is a parameter of that driver.

A driver's ``window(seconds)`` starts calls until ``seconds`` have passed
on the host's clock, lets the last one finish and synchronizes: its rate
is all the work of those calls over all of their time.
"""

from __future__ import annotations

import importlib.util
import pathlib

import torch


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load(path: pathlib.Path, prefix: str):
    """The module in file ``path``, found by its name alone."""
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(mix: dict, root: pathlib.Path):
    """The driver class of a mix: ``benchmark/drivers/<driver>.py``."""
    path = root / "benchmark" / "drivers" / f"{mix['driver']}.py"
    return load(path, "bench_driver").Driver
