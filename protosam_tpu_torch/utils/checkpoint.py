"""Checkpoints: the reference's ``.pth`` snapshots and the JAX package's
orbax checkpoints into the port's modules (JAX ``utils/checkpoint.py``),
and the trainer's rolling snapshots (``CheckpointManager``).

The reference saves plain ``torch.save(state_dict)`` snapshots
(training.py:235-238) and reloads them strictly (grid_proto_fewshot.py:41-44).
The port's modules use the reference's key names, so a snapshot loads
as it is; the layout is auto-detected as JAX's ``load_torch_snapshot``
does.  An orbax checkpoint (JAX's ``save_params``, or a step of its
``CheckpointManager``) is read without orbax, which imports jax: its
``_METADATA`` names the tree, and ``tensorstore`` reads each array through
the OCDBT key-value store and the zarr driver orbax wrote them with; the
params go through the converters of ``utils/convert.py``.  The trainer's
snapshots are the port's own ``torch.save`` files.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from protosam_tpu_torch.utils import convert

_RESNET = ("backbone.", "localconv.")


def load_params(path: str) -> dict[str, torch.Tensor]:
    """A ``.pth`` / ``.pt`` snapshot (``load_torch_snapshot``), or an orbax
    checkpoint directory (``load_orbax``), as a state_dict."""
    if path.endswith((".pth", ".pt")):
        return load_torch_snapshot(path)
    return load_orbax(path)


def _checkpoint_dir(directory: str) -> str:
    """``directory`` itself, or the newest step of a CheckpointManager
    directory (``<step>/default``)."""
    if os.path.isfile(os.path.join(directory, "_METADATA")):
        return directory
    steps = sorted((int(d) for d in os.listdir(directory) if d.isdigit()),
                   reverse=True) if os.path.isdir(directory) else []
    for step in steps:
        for sub in ("default", ""):
            d = os.path.join(directory, str(step), sub)
            if os.path.isfile(os.path.join(d, "_METADATA")):
                return d
    raise FileNotFoundError(f"{directory!r} holds no orbax checkpoint "
                            f"(no _METADATA, no step directory with one)")


def read_orbax(directory: str) -> dict:
    """The tree of an orbax checkpoint as nested dicts of numpy arrays
    (sequence entries keyed by their index; bfloat16 arrays upcast to
    float32, which is exact); ``None`` leaves are left out.  Needs
    ``tensorstore``, not orbax or jax."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError("reading an orbax checkpoint needs the "
                          "'tensorstore' package, which is not installed"
                          ) from e
    d = os.path.abspath(_checkpoint_dir(directory))
    with open(os.path.join(d, "_METADATA")) as f:
        meta = json.load(f)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    if not meta.get("use_ocdbt", True):
        raise NotImplementedError(f"{d!r}: only OCDBT orbax checkpoints are "
                                  f"read")
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        if entry["value_metadata"].get("skip_deserialize"):
            continue
        keys = [k["key"] for k in entry["key_metadata"]]
        spec = {"driver": driver,
                "kvstore": {"driver": "ocdbt", "base": f"file://{d}/",
                            "path": ".".join(keys) + "/"}}
        leaf = np.asarray(ts.open(spec, open=True).result().read().result())
        if leaf.dtype.name == "bfloat16":
            leaf = leaf.astype(np.float32)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def _sam_globals(params: dict) -> tuple[int, ...]:
    from protosam_tpu_torch.models.sam.registry import _CONFIGS

    width = np.asarray(params["image_encoder"]["pos_embed"]).shape[-1]
    for cfg in _CONFIGS.values():
        if cfg["encoder_embed_dim"] == width:
            return cfg["encoder_global_attn_indexes"]
    raise ValueError(f"no SAM of width {width}")


def load_orbax(directory: str) -> dict[str, torch.Tensor]:
    """An orbax checkpoint of JAX params as the port's state_dict: a
    ``FewShotSeg``'s (``{"encoder": ...}``, DINOv2 or ResNet-101) or a
    SAM's (``image_encoder`` ...), through ``utils/convert``; a trainer
    step's ``params`` are taken from its state."""
    tree = read_orbax(directory)
    params = tree.get("params", tree)
    if "image_encoder" in params:
        return convert.sam_state_dict(params, _sam_globals(params))
    if "encoder" in params:
        return convert.fewshot_state_dict(params)
    raise ValueError(f"{directory!r}: neither FewShotSeg params (encoder) "
                     f"nor SAM params (image_encoder): "
                     f"{sorted(params)[:5]}")


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
