"""Checkpoint loading: the reference's ``.pth`` snapshots into the port's
modules (JAX ``utils/checkpoint.py:29-70``).

The reference saves plain ``torch.save(state_dict)`` snapshots
(training.py:235-238) and reloads them strictly (grid_proto_fewshot.py:41-44).
The port's modules use the reference's key names, so a snapshot loads
as it is; the layout is auto-detected as JAX's ``load_torch_snapshot``
does.  Orbax checkpoints are JAX's and are not read here.
"""

from __future__ import annotations

import torch

_RESNET = ("backbone.", "localconv.")
_RESNET_ERROR = ("the DeepLab ResNet-101 coarse backbone is not ported yet "
                 "(ROADMAP §1 item 14)")


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
    ALPNet snapshot, whose DINOv2 keys are ``FewShotSeg``'s (other keys
    dropped, the classifier head having no parameters); bare hub keys give
    DINOv2's.  ``{"state_dict": ...}`` is unwrapped.  A DeepLab ResNet
    layout raises."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    keys = list(sd)
    if any(k.startswith("image_encoder.") for k in keys):
        return dict(sd)
    if any(k.startswith("encoder.") for k in keys):
        enc = {k: v for k, v in sd.items() if k.startswith("encoder.")}
        if any(k[len("encoder."):].startswith(_RESNET) for k in enc):
            raise NotImplementedError(_RESNET_ERROR)
        return enc
    if any(k.startswith(_RESNET) for k in keys):
        raise NotImplementedError(_RESNET_ERROR)
    return dict(sd)
