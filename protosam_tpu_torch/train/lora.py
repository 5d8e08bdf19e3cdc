"""LoRA for the DINOv2 encoder (JAX ``train/lora.py``; reference
util/lora.py).

The factors live apart from the model, keyed by JAX's param paths
(``encoder/blocks/attn/qkv``: the kernel's path in JAX's tree without
``kernel``), one (layers, in, r) ``a`` and (layers, r, out) ``b`` for
each target kind, as JAX stacks them over its scanned blocks; layer i
of the port's ``blocks.{i}.attn.qkv.weight`` (out, in) takes
``scale · (a[i] @ b[i])ᵀ``.  ``merge_lora`` is a pure function of a
state_dict, so a LoRA-only step differentiates the factors while the
base weights stay as they are.

Files are safetensors written by hand (the card has no ``safetensors``
package): an 8-byte little-endian header length, a JSON header with each
tensor's dtype, shape and ``data_offsets`` and ``__metadata__`` holding
``scale`` and ``rank``, then the raw little-endian bytes.  Tensor names
are JAX's (``<path>:a`` / ``<path>:b``), so files pass both ways between
the port and JAX's ``save_lora`` / ``load_lora``.
"""

from __future__ import annotations

import json
import re
import struct

import numpy as np
import torch

# DINOv2 attention + MLP linears (reference util/lora.py:168-170)
DEFAULT_TARGETS = ("qkv", "proj", "mlp_fc1", "mlp_fc2")
# JAX's block path of each target -> the port's module path in a block
_BLOCK_PATHS = {"qkv": ("attn/qkv", "attn.qkv"),
                "proj": ("attn/proj", "attn.proj"),
                "mlp_fc1": ("mlp_fc1", "mlp.fc1"),
                "mlp_fc2": ("mlp_fc2", "mlp.fc2")}
_DTYPES = {np.dtype("float32"): "F32", np.dtype("float16"): "F16",
           np.dtype("float64"): "F64", np.dtype("int32"): "I32",
           np.dtype("int64"): "I64"}


def _target_keys(state_dict: dict, targets) -> dict[str, list[str]]:
    """JAX factor name -> the per-layer weight keys of ``state_dict``, in
    layer order."""
    out: dict[str, list[tuple[int, str]]] = {}
    for key in state_dict:
        for t in targets:
            jax_path, port_path = _BLOCK_PATHS[t]
            m = re.fullmatch(rf"(.*)blocks\.(\d+)\.{re.escape(port_path)}"
                             r"\.weight", key)
            if m:
                name = m.group(1).replace(".", "/") + "blocks/" + jax_path
                out.setdefault(name, []).append((int(m.group(2)), key))
    return {n: [k for _, k in sorted(v)] for n, v in out.items()}


def init_lora(state_dict: dict, rank: int = 4, seed: int = 0,
              targets=DEFAULT_TARGETS, scale: float = 1.0) -> dict:
    """The factor tree {"scale", "rank", "factors": {name: {"a", "b"}}}:
    a ~ N(0, 1)/r from ``seed`` and b = 0, the reference's init, so the
    first merge is the identity."""
    rng = np.random.default_rng(seed)
    factors = {}
    for name, keys in _target_keys(state_dict, targets).items():
        d_out, d_in = state_dict[keys[0]].shape
        a = rng.standard_normal((len(keys), d_in, rank), dtype=np.float32)
        factors[name] = {"a": torch.from_numpy(a / rank),
                         "b": torch.zeros(len(keys), rank, d_out)}
    return {"scale": scale, "rank": rank, "factors": factors}


def merge_lora(state_dict: dict, lora: dict,
               targets=DEFAULT_TARGETS) -> dict:
    """W' = W + scale · (a @ b)ᵀ for every adapted weight (a new dict;
    differentiable in the factors)."""
    out = dict(state_dict)
    for name, keys in _target_keys(state_dict, targets).items():
        f = lora["factors"].get(name)
        if f is None:
            continue
        for i, key in enumerate(keys):
            w = state_dict[key]
            delta = (f["a"][i].to(w.device) @ f["b"][i].to(w.device))
            out[key] = w + lora["scale"] * delta.t().to(w.dtype)
    return out


def collapse_lora(state_dict: dict, lora: dict) -> dict:
    """Fold the adapters into the base weights for good (reference
    collapse_lora, util/lora.py:638-673)."""
    return {k: v.detach() for k, v in merge_lora(state_dict, lora).items()}


def save_lora(path: str, lora: dict) -> None:
    tensors = {}
    for name, f in lora["factors"].items():
        for part in ("a", "b"):
            tensors[f"{name}:{part}"] = np.ascontiguousarray(
                f[part].detach().cpu().numpy())
    header, offset = {}, 0
    for key in sorted(tensors):
        a = tensors[key]
        header[key] = {"dtype": _DTYPES[a.dtype], "shape": list(a.shape),
                       "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    header["__metadata__"] = {"scale": str(lora["scale"]),
                              "rank": str(lora["rank"])}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for key in sorted(tensors):
            fh.write(tensors[key].astype(tensors[key].dtype.newbyteorder(
                "<"), copy=False).tobytes())


def load_lora(path: str) -> dict:
    with open(path, "rb") as fh:
        n = struct.unpack("<Q", fh.read(8))[0]
        header = json.loads(fh.read(n))
        data = fh.read()
    meta = header.pop("__metadata__", None) or {}
    names = {v: k for k, v in _DTYPES.items()}
    factors: dict = {}
    for key, spec in header.items():
        lo, hi = spec["data_offsets"]
        a = np.frombuffer(data[lo:hi], dtype=names[spec["dtype"]].newbyteorder(
            "<")).reshape(spec["shape"])
        name, part = key.rsplit(":", 1)
        factors.setdefault(name, {})[part] = torch.from_numpy(
            a.astype(names[spec["dtype"]]))
    return {"scale": float(meta.get("scale", 1.0)),
            "rank": int(meta.get("rank", 4)), "factors": factors}


def lora_parameters(lora: dict) -> list[torch.Tensor]:
    """The factors as leaf tensors that require grad, in a fixed order
    (the ones a LoRA optimizer steps)."""
    params = []
    for name in sorted(lora["factors"]):
        for part in ("a", "b"):
            t = lora["factors"][name][part]
            if not t.requires_grad:
                t.requires_grad_()
            params.append(t)
    return params


class _Bound(torch.nn.Module):
    def __init__(self, model, loss_fn):
        super().__init__()
        self.model, self.loss_fn = model, loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


def lora_train_step(model: torch.nn.Module, lora: dict, optimizer,
                    loss_fn, batch):
    """One step that trains only the factors: ``loss_fn(model, batch)``
    -> (loss, aux) runs on the merged weights (``torch.func.
    functional_call``), the model's own parameters are never written, and
    ``optimizer`` (``train.step.make_optimizer(lora_parameters(lora))``)
    steps the factors.  Returns (loss, aux)."""
    base = {k: v.detach() for k, v in model.state_dict().items()}
    merged = merge_lora(base, lora)
    swapped = {"model." + k: v for k, v in merged.items()
               if v is not base[k]}
    loss, aux = torch.func.functional_call(_Bound(model, loss_fn), swapped,
                                           (batch,), strict=False)
    optimizer.step(torch.autograd.grad(loss, lora_parameters(lora)))
    return loss.detach(), aux
