"""The (data, model) grid over ``torch.distributed`` ranks, and the Megatron
split of the encoders (JAX ``parallel/sharding.py``).

JAX drives a device mesh from one controller; the port runs one process a
card (``torchrun``, or ``torch.multiprocessing``), every rank building the
same seeded weights.  The caller initialises the process group and owns
its backend (NCCL on cards, gloo on the CPU); nothing here starts one.

* **data parallel**: slices of a volume split over the ``data`` axis
  (``shard_batch``; ``ProtoSAM.forward_volume_sharded``);
* **tensor parallel**: the encoders' attention heads and MLP hidden units
  split over the ``model`` axis (``encoder_param_sharding``), each
  row-parallel output all-reduced over the model group.

Collectives go through ``all_reduce_sum`` / ``all_gather`` / ``isend`` /
``irecv`` here, which count themselves in ``collective_calls``.  gloo takes
CUDA tensors in all_reduce and all_gather (it copies them itself), not in
send/recv (a CUDA send broke a two-rank gloo group on an H100), so under
gloo a point-to-point transfer of a CUDA tensor is staged through host
memory, decided by the backend's name; every other collective, and every
NCCL one, moves device tensors.
"""

from __future__ import annotations

import collections
import dataclasses
import logging

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from protosam_tpu_torch.ops.quant import QuantLinear

log = logging.getLogger("parallel")

# collective kind -> calls made through this module (read by the tests and
# tools/measure_dp_scaling)
collective_calls: collections.Counter = collections.Counter()


def _require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group: initialise "
                           "one (NCCL on cards, gloo on the CPU) first")


_staged_logged = False


def host_staged(t: torch.Tensor) -> bool:
    """Whether a send or receive of ``t`` goes through host memory: under
    gloo for a CUDA tensor (by the backend's name, never after a
    failure)."""
    global _staged_logged
    staged = t.is_cuda and dist.get_backend() == "gloo"
    if staged and not _staged_logged:
        _staged_logged = True
        log.info("gloo backend: CUDA tensors of send/recv are staged through "
                 "host memory")
    return staged


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) grid: rank ``d * n_model +
    m`` sits at (d, m).  ``data_group`` holds the ranks of this rank's model
    index (the slices' all-gather), ``model_group`` those of its data index
    (the tensor-parallel all-reduce)."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The (data, model) grid over the world's ranks, with its two sets of
    subgroups (every rank creates every group, as ``new_group`` needs)."""
    _require_group()
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model}"
                         f" ranks, the world has {world}")
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    d, m = divmod(rank, n_model)
    return Mesh(n_data, n_model, d, m, data_groups[m], model_groups[d])


def shard_batch(batch, mesh: Mesh):
    """This rank's block of the leading (batch) axis of every tensor in
    ``batch`` (a tensor, or a dict / list / tuple of them) over ``data``;
    the axis must divide by the data size."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    n = batch.shape[0]
    if n % mesh.n_data:
        raise ValueError(f"batch of {n} does not split over {mesh.n_data} "
                         f"data ranks")
    k = n // mesh.n_data
    return batch[mesh.data_rank * k:(mesh.data_rank + 1) * k]


# ---- collectives ------------------------------------------------------------


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    collective_calls["all_reduce"] += 1
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (all the same shape), in group-rank order."""
    collective_calls["all_gather"] += 1
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def isend(t: torch.Tensor, dst: int):
    """Start sending ``t`` to world rank ``dst``; returns (work, the tensor
    sent), which must live until the work is waited."""
    collective_calls["send"] += 1
    src = t.cpu() if host_staged(t) else t.contiguous()
    return dist.isend(src, dst), src


def irecv(shape, dtype, device, src: int):
    """Start receiving a tensor from world rank ``src``; returns (work, the
    buffer), the buffer on the host under gloo for a CUDA ``device``."""
    collective_calls["recv"] += 1
    buf = torch.empty(shape, dtype=dtype, device=device)
    if host_staged(buf):
        buf = torch.empty(shape, dtype=dtype)
    return dist.irecv(buf, src), buf


# ---- the Megatron split -----------------------------------------------------

# (JAX ``parallel/sharding.py:37-38``)
#   column-parallel (output units): qkv, DINOv2's mlp.fc1, SAM's lin1, the
#     decoder's q_proj / k_proj / v_proj, with their biases; the gated
#     FFN's mlp.w12 by the same hidden units in each of its two halves;
#   row-parallel (input units): proj, mlp.fc2, mlp.w3, lin2, out_proj; the
#     partial products all-reduced over the model group, then the bias
#     added once.
#
# Which routes take a shard, as under JAX's shard_params=True: kernels K6
# (``dense_residual``, the fused projection) and K7 (``mlp_fused``) take
# none: GSPMD hands a Pallas call its operands whole, so a block whose
# bf16 projection or MLP runs on them stays replicated here.  QuantLinear
# (the int8 path, K8 and K9) takes none: its per-row and per-column scales
# run over the whole of K, and JAX's GSPMD keeps the replicated program's
# results, as keeping the layer whole does.  K1-K4 run on every rank's
# share of heads and rows.


class RowParallelLinear(nn.Module):
    """``x @ W[:, shard].T``, all-reduced over the model group, plus the
    whole bias."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None,
                 group):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(
            bias, requires_grad=False)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = all_reduce_sum(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def _column(lin: nn.Linear, rows: torch.Tensor) -> nn.Linear:
    out = nn.Linear(lin.in_features, len(rows), bias=lin.bias is not None,
                    device="meta")
    out.weight = nn.Parameter(lin.weight.detach()[rows].clone(),
                              requires_grad=False)
    if lin.bias is not None:
        out.bias = nn.Parameter(lin.bias.detach()[rows].clone(),
                                requires_grad=False)
    return out


def _row(lin: nn.Linear, cols: torch.Tensor, group) -> RowParallelLinear:
    bias = None if lin.bias is None else lin.bias.detach().clone()
    return RowParallelLinear(lin.weight.detach()[:, cols].clone(), bias,
                             group)


def _units(n: int, mesh: Mesh, what: str) -> torch.Tensor:
    if n % mesh.n_model:
        raise ValueError(f"{what}: {n} does not split over {mesh.n_model} "
                         f"model ranks")
    k = n // mesh.n_model
    return torch.arange(mesh.model_rank * k, (mesh.model_rank + 1) * k)


def _plain(*layers) -> bool:
    """Layers on the plain route: dense, not int8."""
    return all(isinstance(lin, nn.Linear) and not isinstance(lin, QuantLinear)
               for lin in layers)


def _bf16(module: nn.Module) -> bool:
    return next(module.parameters()).dtype == torch.bfloat16


def encoder_param_sharding(module: nn.Module, mesh: Mesh) -> dict[str, str]:
    """Megatron-split ``module``'s transformer layers over ``mesh``'s model
    axis, in place (each rank keeps its shard; the rest is freed), and
    return {layer name: "column" | "row"}.  Attention splits by heads:
    qkv's rows head by head of q, k and v, and the head count each rank
    runs; the MLP by hidden units (the gated FFN's gate and value rows of
    the same units together).  A no-op at one model rank."""
    if mesh.n_model == 1:
        return {}
    plan: dict[str, str] = {}
    for name, mod in list(module.named_modules()):
        fused_proj = getattr(mod, "fused_proj", False)
        fused_mlp = getattr(mod, "fused_mlp", False)
        attn = getattr(mod, "attn", None)
        if attn is not None and hasattr(attn, "qkv") \
                and _plain(attn.qkv, attn.proj) \
                and not (fused_proj and _bf16(attn)):
            _split_packed_attention(attn, mesh)
            plan[f"{name}.attn.qkv"] = "column"
            plan[f"{name}.attn.proj"] = "row"
        mlp = getattr(mod, "mlp", None)
        pair = next((p for p in (("fc1", "fc2"), ("lin1", "lin2"),
                                 ("w12", "w3")) if hasattr(mlp, p[0])), None)
        if pair and _plain(*(getattr(mlp, p) for p in pair)) \
                and not (fused_mlp and _bf16(mlp)):
            up, down = (getattr(mlp, p) for p in pair)
            units = _units(down.in_features, mesh, f"{name}.mlp")
            # w12's rows are the gate's hidden units, then the value's
            rows = torch.cat([units, units + down.in_features]) \
                if pair[0] == "w12" else units
            setattr(mlp, pair[0], _column(up, rows))
            setattr(mlp, pair[1], _row(down, units, mesh.model_group))
            plan[f"{name}.mlp.{pair[0]}"] = "column"
            plan[f"{name}.mlp.{pair[1]}"] = "row"
        if hasattr(mod, "q_proj") and _plain(mod.q_proj, mod.k_proj,
                                             mod.v_proj, mod.out_proj):
            heads = _units(mod.num_heads, mesh, f"{name} heads")
            hd = mod.q_proj.out_features // mod.num_heads
            units = (heads[:, None] * hd + torch.arange(hd)).reshape(-1)
            for p in ("q_proj", "k_proj", "v_proj"):
                setattr(mod, p, _column(getattr(mod, p), units))
                plan[f"{name}.{p}"] = "column"
            mod.out_proj = _row(mod.out_proj, units, mesh.model_group)
            plan[f"{name}.out_proj"] = "row"
            mod.num_heads = len(heads)
    return plan


def _split_packed_attention(attn: nn.Module, mesh: Mesh) -> None:
    """qkv's output is (3, heads, head_dim): keep this rank's heads of each
    of q, k and v; proj takes the same channels as its input."""
    c = attn.qkv.in_features
    heads = _units(attn.num_heads, mesh, "attention heads")
    hd = c // attn.num_heads
    units = (heads[:, None] * hd + torch.arange(hd)).reshape(-1)
    attn.qkv = _column(attn.qkv, torch.cat([units + t * c for t in range(3)]))
    attn.proj = _row(attn.proj, units, mesh.model_group)
    attn.num_heads = len(heads)


__all__ = ["Mesh", "make_mesh", "shard_batch", "encoder_param_sharding",
           "RowParallelLinear", "all_reduce_sum", "all_gather", "isend",
           "irecv", "host_staged", "collective_calls"]
