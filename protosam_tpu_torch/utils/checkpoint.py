"""Checkpoints: the reference's ``.pth`` snapshots into the port's modules
(JAX ``utils/checkpoint.py:29-70``), and the trainer's rolling snapshots
(``CheckpointManager``).

The reference saves plain ``torch.save(state_dict)`` snapshots
(training.py:235-238) and reloads them strictly (grid_proto_fewshot.py:41-44).
The port's modules use the reference's key names, so a snapshot loads
as it is; the layout is auto-detected as JAX's ``load_torch_snapshot``
does.  Orbax checkpoints are JAX's and are not read here (ROADMAP §1
item 26); the trainer's snapshots are the port's own ``torch.save`` files.
"""

from __future__ import annotations

import os
import re

import torch

_RESNET = ("backbone.", "localconv.")


def load_params(path: str) -> dict[str, torch.Tensor]:
    """A ``.pth`` / ``.pt`` snapshot as a state_dict
    (``load_torch_snapshot``); anything else is taken for an orbax
    directory, which JAX writes and the port does not read."""
    if path.endswith((".pth", ".pt")):
        return load_torch_snapshot(path)
    raise NotImplementedError(
        f"{path!r} is not a .pth/.pt snapshot; orbax checkpoints are the "
        f"JAX package's and are not read by the port")


def load_torch_snapshot(path: str) -> dict[str, torch.Tensor]:
    """The state_dict of a reference snapshot, in the layout of the module
    it is for: ``image_encoder.*`` keys give SAM's; ``encoder.*`` keys an
    ALPNet snapshot, whose DINOv2 or DeepLab ResNet-101 keys are
    ``FewShotSeg``'s (other keys dropped, the classifier head having no
    parameters); bare hub keys give DINOv2's, bare ``backbone.`` /
    ``localconv.`` keys ``FewShotSeg``'s ResNet (under ``encoder.``, as
    JAX puts them under ``encoder``).  ``{"state_dict": ...}`` and the
    trainer's snapshots (``{"model": ...}``) are unwrapped; torchvision's ``num_batches_tracked`` counters are dropped
    (the frozen BatchNorm keeps none)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):  # the trainer's: "model"
        if isinstance(sd, dict) and wrapper in sd:
            sd = sd[wrapper]
    keys = list(sd)
    if any(k.startswith("image_encoder.") for k in keys):
        return dict(sd)
    if any(k.startswith("encoder.") for k in keys):
        sd = {k: v for k, v in sd.items() if k.startswith("encoder.")}
    elif any(k.startswith(_RESNET) for k in keys):
        sd = {"encoder." + k: v for k, v in sd.items()}
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


class CheckpointManager:
    """Rolling training snapshots with resume (JAX's is an orbax
    ``CheckpointManager``, ``utils/checkpoint.py:72``): one ``torch.save``
    file a step under ``directory``, holding the model's state_dict, the
    optimizer's state and the step; the newest ``max_to_keep`` stay."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> list[int]:
        found = (re.fullmatch(r"step_(\d+)\.pt", f)
                 for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, model: torch.nn.Module, optimizer) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save({"step": step, "model": model.state_dict(),
                    "optimizer": optimizer.state_dict()}, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, model: torch.nn.Module, optimizer,
                step: int | None = None) -> int | None:
        """Load the newest snapshot (or ``step``'s) into ``model`` and
        ``optimizer``; returns its step, or None when there is none."""
        steps = self.steps()
        if step is None:
            if not steps:
                return None
            step = steps[-1]
        dev = next(model.parameters()).device
        snap = torch.load(self._path(step), map_location=dev,
                          weights_only=True)
        model.load_state_dict(snap["model"])
        optimizer.load_state_dict(snap["optimizer"])
        return int(snap["step"])
