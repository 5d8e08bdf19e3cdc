"""The multi-GPU volume path on the card: the counterpart of
``tools/measure_dp_scaling.py``, and the rank launcher the other parallel
tools and the smoke run use.

Measures, for the dp program (``ProtoSAM.forward_volume_sharded`` over R
ranks, one process a rank):

1. **same-work overhead**: the wall time of the dp program over N slices
   against one rank's ``forward_volume`` of the same N slices at the same
   per-program batch (N / R), run alone first.  When the ranks share one
   card the ratio is the dp program's own overhead (launches, the gather,
   the second process's contention); on R cards the parallel efficiency is
   at least 1 / (1 + overhead);
2. **collectives in the dp step**: those issued before the final gather,
   counted through ``parallel.sharding.collective_calls`` and at
   ``torch.distributed`` itself (JAX counts them in the compiled HLO): 0;
3. **bit-equality** of the dp masks with ``forward_volume``'s, and the
   largest score gap.

The backend is NCCL, the default on cards, logged; NCCL refuses two ranks
on one device, so with fewer cards than ranks pass ``--backend gloo``
(the ranks then share the cards).  Raises without a card.

    python3 -m protosam_tpu_torch.tools.measure_dp_scaling
        [--config flagship|tiny] [--ranks 2] [--slices 8] [--reps 3]
        [--backend nccl|gloo] [--paths] [--out runs/dp_scaling.json]

``--paths`` adds ``check_paths``: dp, tp and pp each against one rank's
``forward_volume`` of the same slices (the smoke run's phase 11c).
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing as mp
import os
import pickle
import socket
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from protosam_tpu_torch.tools.timing import card, log, require_cuda

RAW = ("all_reduce", "all_gather", "broadcast", "isend", "irecv", "send",
       "recv", "all_gather_object", "reduce_scatter")
# the main path's kernels: wrapper -> its launch counter
KERNELS = ("layer_norm_rows", "packed_masked_attention",
           "relpos_patch_attention", "cca_label")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, ranks, backend, port, out_dir, fn, args):
    try:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=ranks, timeout=datetime.timedelta(seconds=300))
        res = fn(rank, *args)
        dist.barrier()
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def launch(fn, ranks: int, *args, backend: str | None = None,
           timeout: float = 900.0) -> list:
    """``fn(rank, *args)`` in ``ranks`` processes, each on card ``rank %
    device_count`` in a process group of ``backend`` (NCCL unless given);
    their results, rank
    by rank.  A rank that fails fails the launch (its traceback raised); a
    rank still running after ``timeout`` s is killed."""
    require_cuda()
    backend = backend or "nccl"
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, ranks, backend, port, tmp, fn, args))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        errs = [open(os.path.join(tmp, f)).read()
                for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
        if errs:
            raise RuntimeError(f"a rank failed (exit codes "
                               f"{[p.exitcode for p in procs]}):\n"
                               + "\n".join(errs))
        if alive:
            raise RuntimeError(f"ranks did not finish within {timeout} s")
        if any(p.exitcode for p in procs):
            raise RuntimeError(f"ranks exited with codes "
                               f"{[p.exitcode for p in procs]}")
        out = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def kernel_counts() -> dict:
    """The launch counters of the main path's kernels (K1-K4)."""
    from protosam_tpu_torch.ops.attention import \
        masked_flash_attention_packed
    from protosam_tpu_torch.ops.cca import label_components
    from protosam_tpu_torch.ops.norm import layer_norm_rows
    from protosam_tpu_torch.ops.vitdet_flash import relpos_patch_attention

    fns = (layer_norm_rows, masked_flash_attention_packed,
           relpos_patch_attention, label_components)
    return {k: f.launches for k, f in zip(KERNELS, fns)}


def build(config: str, n_slices: int):
    """(pipe, queries, episode) of ``config`` on this rank's card: the
    flagship (DINOv2-L/14 672 + SAM ViT-B, bf16) or the tiny f32 pipeline
    (dinov2_t14 126 + SAM vit_t 256), seeded: every rank builds the same."""
    from protosam_tpu_torch.entry import build_pipeline
    from protosam_tpu_torch.pipeline.protosam import ProtoSAMConfig
    from protosam_tpu_torch.tools.pipeline_profile import volume_inputs
    from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                    synthetic_episode)

    dev = torch.device("cuda", torch.cuda.current_device())
    if config == "flagship":
        pipe = build_pipeline(dev)
        vol, inp = volume_inputs(n_slices, dev)
        return pipe, vol, inp
    pipe = build_pipeline(dev, sam_ver="vit_t", coarse="dinov2_t14",
                          image_size=126, sam_size=256, dtype=torch.float32,
                          config=ProtoSAMConfig(image_size=(256, 256),
                                                max_ccs=4))
    return (pipe, smooth_volume(n_slices, 126, 6).to(dev),
            synthetic_episode(126, dev, 7))


def _count_raw(counts: dict) -> None:
    for name in RAW:
        fn = getattr(dist, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)
        setattr(dist, name, wrapped)


def _sync_ms(fn) -> tuple[float, object]:
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def dp_rank(rank: int, config: str, n_slices: int, reps: int) -> dict:
    """One rank of the measurement: rank 0 times the single-rank arm alone,
    then every rank times the dp program; rank 0 also holds its masks to
    the single arm's."""
    from protosam_tpu_torch.parallel import make_mesh
    from protosam_tpu_torch.parallel import sharding

    world = dist.get_world_size()
    pipe, vol, inp = build(config, n_slices)
    per_rank = n_slices // world
    single_ms, single = [], None
    for i in range(reps + 1):  # the first run warms up
        if rank == 0:
            ms, single = _sync_ms(lambda: pipe.forward_volume(
                vol, inp, slice_batch=per_rank))
            single_ms.append(ms)
        else:
            dist.barrier()
    mesh = make_mesh(n_data=world)
    dp_ms, got = [], None
    for i in range(reps + 1):
        ms, got = _sync_ms(lambda: pipe.forward_volume_sharded(
            vol, inp, mesh, slice_batch=n_slices))
        dp_ms.append(ms)
    # the collectives of one more dp run, before and after its last block
    raw, seen = {}, []
    _count_raw(raw)
    sharding.collective_calls.clear()
    core = pipe._forward_core

    def recorded(*a, **kw):
        seen.append(sum(raw.values()) + sum(
            sharding.collective_calls.values()))
        return core(*a, **kw)
    pipe._forward_core = recorded
    launches = kernel_counts()
    pipe.forward_volume_sharded(vol, inp, mesh, slice_batch=n_slices)
    torch.cuda.synchronize()
    launches = {k: v - launches[k] for k, v in kernel_counts().items()}
    out = {"single_ms": single_ms[1:], "dp_ms": dp_ms[1:],
           "collectives_before_gather": max(seen),
           "collectives": dict(raw), "launches": launches,
           "backend": dist.get_backend()}
    if rank == 0:
        out["bit_equal"] = bool(torch.equal(got[0], single[0]))
        out["max_score_gap"] = float((got[1] - single[1]).abs().max())
    return out


def paths_rank(rank: int, config: str, n_slices: int, modes: tuple
               ) -> dict:
    """One rank of the multi-GPU paths over the same ``n_slices``: the
    single-rank ``forward_volume`` at the per-rank batch, then each of
    ``modes`` in order: ``dp`` (2 data ranks), ``tp`` (``shard_params``
    over the model ranks) and ``pp`` (stage A rank 0, stage B the rest;
    it frees each stage's other weights, so it comes last).  Returns the
    masks, the scores, the wall ms and the K1-K4 launches of each."""
    from protosam_tpu_torch.parallel import PipelinedVolumeRunner, make_mesh

    world = dist.get_world_size()
    out = {"backend": dist.get_backend()}
    pipe, vol, inp = build(config, n_slices)
    batch = n_slices // world
    ref = pipe.forward_volume(vol, inp, slice_batch=batch)
    out["ref"] = (ref[0].cpu(), ref[1].cpu())
    meshes = {"dp": make_mesh(n_data=world),
              "tp": make_mesh(n_data=1, n_model=world)}
    for mode in modes:
        before = kernel_counts()
        if mode == "pp":
            runner = PipelinedVolumeRunner(pipe, [0], list(range(1, world)))
            ms, got = _sync_ms(lambda: runner(vol, inp, microbatch=batch))
        else:
            ms, got = _sync_ms(lambda: pipe.forward_volume_sharded(
                vol, inp, meshes[mode],
                slice_batch=n_slices if mode == "dp" else batch,
                shard_params=mode == "tp"))
        out[mode] = {"preds": got[0].cpu(), "scores": got[1].cpu(),
                     "ms": ms, "launches": {
                         k: v - before[k] for k, v in kernel_counts().items()}}
    return out


def _dice(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a > 0.5, b > 0.5
    den = (a.sum() + b.sum()).item()
    return 1.0 if den == 0 else 2.0 * (a & b).sum().item() / den


def check_paths(config: str = "flagship", ranks: int = 2, n_slices: int = 8,
                backend: str | None = None) -> list[dict]:
    """dp, tp and pp (``paths_rank``) over ``ranks`` ranks, each rank's
    result against its own single-rank ``forward_volume``: dp masks
    bit-equal and the largest score gap, tp's mean and least mask Dice, pp
    masks equal, the wall ms and the K1-K4 launches of each path.  Logs a
    line a rank and returns them; the caller holds them to its bounds."""
    require_cuda()
    backend = backend or "nccl"
    res = launch(paths_rank, ranks, config, n_slices, ("dp", "tp", "pp"),
                 backend=backend)
    out = []
    for r, x in enumerate(res):
        ref_p, ref_s = x["ref"]
        dices = [_dice(a, b) for a, b in zip(x["tp"]["preds"], ref_p)]
        row = {"rank": r, "backend": x["backend"],
               "dp_bit_equal": bool(torch.equal(x["dp"]["preds"], ref_p)),
               "dp_score_gap": float((x["dp"]["scores"] - ref_s).abs().max()),
               "tp_mean_dice": float(sum(dices) / len(dices)),
               "tp_min_dice": float(min(dices)),
               "pp_equal": bool(torch.equal(x["pp"]["preds"], ref_p)),
               "ms": {m: x[m]["ms"] for m in ("dp", "tp", "pp")},
               "launches": {m: x[m]["launches"] for m in ("dp", "tp", "pp")}}
        log(f"paths rank {r} ({row['backend']}, {ranks} ranks on "
            f"{torch.cuda.device_count()} card(s)): dp masks bit-equal "
            f"{row['dp_bit_equal']}, scores within {row['dp_score_gap']:.2e}"
            f"; tp mean Dice {row['tp_mean_dice']:.5f} (min "
            f"{row['tp_min_dice']:.5f}); pp masks equal {row['pp_equal']}; "
            f"wall ms dp {row['ms']['dp']:.1f}, tp {row['ms']['tp']:.1f}, "
            f"pp {row['ms']['pp']:.1f}; launches {row['launches']}")
        out.append(row)
    return out


def run(config: str = "flagship", ranks: int = 2, n_slices: int = 8,
        reps: int = 3, backend: str | None = None) -> dict:
    require_cuda()
    backend = backend or "nccl"
    log(f"measure_dp_scaling: {ranks} ranks on {torch.cuda.device_count()} "
        f"card(s), backend {backend}")
    res = launch(dp_rank, ranks, config, n_slices, reps, backend=backend)
    t_single = min(res[0]["single_ms"])
    t_dp = max(min(r["dp_ms"]) for r in res)
    out = {"config": config, "ranks": ranks, "cards": torch.cuda.device_count(),
           "backend": backend, "slices": n_slices,
           "t_single_rank_ms": t_single, "t_dp_same_work_ms": t_dp,
           "dp_program_overhead": t_dp / t_single - 1.0,
           "collectives_before_gather": max(
               r["collectives_before_gather"] for r in res),
           "collectives": res[0]["collectives"],
           "dp_bit_equal_to_forward_volume": res[0]["bit_equal"],
           "max_score_gap": res[0]["max_score_gap"],
           "launches_by_rank": [r["launches"] for r in res],
           "card": card()}
    log(f"measure_dp_scaling {config}: {n_slices} slices, single rank "
        f"{t_single:.1f} ms, dp over {ranks} ranks {t_dp:.1f} ms (same "
        f"work): overhead {out['dp_program_overhead']:+.4f}; collectives "
        f"before the gather {out['collectives_before_gather']}, in all "
        f"{out['collectives']}; masks bit-equal "
        f"{out['dp_bit_equal_to_forward_volume']}, scores within "
        f"{out['max_score_gap']:.2e}")
    return out


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="flagship",
                    choices=("flagship", "tiny"))
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--slices", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--backend", choices=("nccl", "gloo"))
    ap.add_argument("--paths", action="store_true",
                    help="also run dp, tp and pp against forward_volume")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    out = run(a.config, a.ranks, a.slices, a.reps, a.backend)
    if a.paths:
        out["paths"] = check_paths(a.config, a.ranks, a.slices, a.backend)
    print(json.dumps(out), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
