"""Multi-process dp / tp / pp of the port (``parallel/``,
``ProtoSAM.forward_volume_sharded``) on the CPU: gloo over 2-4 spawned
processes, each building the same seeded tiny pipeline (dinov2_t14 at 126
px + SAM vit_t at 256, f32), held to the single-process ``forward_volume``
to JAX's own tolerances (``tests/test_sharded_eval.py``,
``tests/test_pipeline_parallel.py``: masks equal, scores within 1e-5).
Every multi-process test has its own timeout (``_spawn``)."""

import multiprocessing as mp
import os
import pickle
import tempfile
import traceback

import pytest
import torch
import torch.distributed as dist

from protosam_tpu_torch.entry import build_pipeline
from protosam_tpu_torch.models.io_protocol import ALPNetInput
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.ops.quant import QuantLinear
from protosam_tpu_torch.ops.resize import resize_bilinear
from protosam_tpu_torch.parallel import (PipelinedVolumeRunner,
                                         encoder_param_sharding, make_mesh,
                                         shard_batch)
from protosam_tpu_torch.parallel import sharding
from protosam_tpu_torch.pipeline.protosam import ProtoSAMConfig

TIMEOUT_S = 120
RAW = ("all_reduce", "all_gather", "broadcast", "isend", "irecv", "send",
       "recv", "all_gather_object", "reduce_scatter")


def _worker(rank, world, init, out_dir, fn, args):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        res = fn(rank, *args)
        dist.barrier()
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(fn, world, *args, timeout=TIMEOUT_S):
    """Run ``fn(rank, *args)`` in ``world`` gloo processes; their results,
    rank by rank.  A process still running after ``timeout`` s is killed
    and fails the test."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_worker,
                             args=(r, world, init, tmp, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        errs = [open(os.path.join(tmp, f)).read()
                for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
        assert not errs, errs[0]
        assert not alive, f"ranks still running after {timeout} s"
        assert all(p.exitcode == 0 for p in procs)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _tiny(seed=0):
    cfg = ProtoSAMConfig(image_size=(256, 256), use_cca=True, max_ccs=4)
    pipe = build_pipeline("cpu", sam_ver="vit_t", coarse="dinov2_t14",
                          image_size=126, sam_size=256, dtype=torch.float32,
                          config=cfg, seed=seed)
    g = torch.Generator().manual_seed(3)
    supp = resize_bilinear(torch.randn(1, 3, 21, 21, generator=g),
                           (126, 126)) * 3.0
    fg = torch.zeros(1, 126, 126)
    fg[:, 30:80, 30:80] = 1.0
    return pipe, ALPNetInput(supp, fg, supp)


def _queries(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return resize_bilinear(torch.randn(n, 3, 21, 21, generator=g),
                           (126, 126)) * 3.0


def _count_raw(counts):
    """Count every call of the raw ``torch.distributed`` collectives."""
    for name in RAW:
        fn = getattr(dist, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)
        setattr(dist, name, wrapped)


# ------------------------------------------------------------------- dp / tp


def _sharded(rank, n_data, n_model, n, slice_batch):
    pipe, inp = _tiny()
    queries = _queries(n)
    want = pipe.forward_volume(queries, inp, slice_batch=8)
    mesh = make_mesh(n_data=n_data, n_model=n_model)
    raw, seen = {}, []
    _count_raw(raw)
    core = pipe._forward_core

    def recorded(*a, **kw):
        seen.append((dict(raw), dict(sharding.collective_calls)))
        return core(*a, **kw)
    pipe._forward_core = recorded
    got = pipe.forward_volume_sharded(queries, inp, mesh,
                                      slice_batch=slice_batch,
                                      shard_params=n_model > 1)
    return {"want": want, "got": got, "raw": raw, "seen": seen,
            "calls": dict(sharding.collective_calls)}


def _check_equal(res):
    (wp, ws), (gp, gs) = res["want"], res["got"]
    assert gp.shape == wp.shape and gs.shape == ws.shape
    torch.testing.assert_close(gp, wp, rtol=0, atol=0)
    torch.testing.assert_close(gs, ws, rtol=0, atol=1e-5)


# each multi-process run is made once, in a module fixture, under its own
# timeout; the tests read its results
@pytest.fixture(scope="module")
def dp_runs():
    return {"8-slices": _spawn(_sharded, 2, 2, 1, 8, 8),
            "ragged": _spawn(_sharded, 2, 2, 1, 5, None),
            "steps": _spawn(_sharded, 2, 2, 1, 8, 4)}


@pytest.fixture(scope="module")
def tp_runs():
    return {"tp2": _spawn(_sharded, 2, 1, 2, 8, 8),
            "dp2xtp2": _spawn(_sharded, 4, 2, 2, 8, 8)}


@pytest.mark.parametrize("case", ["8-slices", "ragged"])
def test_dp_matches_forward_volume(dp_runs, case):
    """dp over 2 ranks (JAX's test_sharded_matches_single_device), and a
    ragged volume (5 slices) padded and cropped: every rank returns the
    whole volume, masks equal and scores within 1e-5 of
    ``forward_volume``."""
    for res in dp_runs[case]:
        _check_equal(res)


def test_dp_step_issues_no_collective(dp_runs):
    """The dp step runs with no collective (JAX's
    test_dp_volume_program_has_no_collectives): none before the last
    slice block's ``_forward_core``, raw or through ``parallel``, and then
    the two gathers (preds, scores) only."""
    for res in dp_runs["steps"]:
        _check_equal(res)
        assert len(res["seen"]) == 2  # 8 slices, 4 a step over 2 ranks
        for raw, ours in res["seen"]:
            assert not raw and not ours
        assert res["calls"] == {"all_gather": 2}
        assert res["raw"] == {"all_gather": 2}


@pytest.mark.parametrize("case", ["tp2", "dp2xtp2"])
def test_tp_matches_forward_volume(tp_runs, case):
    """Megatron-sharded encoders over the model axis, 1 x 2 and 2 x 2
    (JAX's test_tp_sharded_inference_matches_replicated): masks equal,
    scores within 1e-5; the row-parallel layers all-reduce."""
    for res in tp_runs[case]:
        _check_equal(res)
        assert res["calls"]["all_reduce"] > 0


def _swap(rank):
    pipe, inp = _tiny(seed=0)
    queries = _queries(4)
    mesh = make_mesh(n_data=1, n_model=2)
    first = pipe.forward_volume_sharded(queries, inp, mesh,
                                        shard_params=True)
    other, _ = _tiny(seed=5)
    pipe.sam_model.load_state_dict(other.sam_model.state_dict())
    pipe.coarse_model.load_state_dict(other.coarse_model.state_dict())
    second = pipe.forward_volume_sharded(queries, inp, mesh,
                                         shard_params=True)
    return {"first": first, "second": second,
            "want": pipe.forward_volume(queries, inp, slice_batch=4)}


@pytest.fixture(scope="module")
def swap_run():
    return _spawn(_swap, 2)


def test_weight_swap_serves_the_new_weights(swap_run):
    """After a swap of the weights in place, the tensor-parallel path runs
    the new weights (JAX's cache, keyed on the mesh only, serves the old
    ones)."""
    for res in swap_run:
        (wp, ws), (gp, gs) = res["want"], res["second"]
        torch.testing.assert_close(gp, wp, rtol=0, atol=0)
        torch.testing.assert_close(gs, ws, rtol=0, atol=1e-5)
        assert not torch.equal(res["first"][1], gs)


# ------------------------------------------------------------------------ pp


def _pipelined(rank, stage_a, stage_b, n, microbatch):
    pipe, inp = _tiny()
    queries = _queries(n, seed=5)
    want = pipe.forward_volume(queries, inp, slice_batch=microbatch)
    runner = PipelinedVolumeRunner(pipe, stage_a, stage_b)
    sizes = {k: sum(p.numel() for p in getattr(pipe, k).parameters())
             for k in ("coarse_model", "sam_model")}
    got = runner(queries, inp, microbatch=microbatch)
    return {"want": want, "got": got, "sizes": sizes}


PP_CASES = {"2+2": (4, [0, 1], [2, 3], 8, 4),
            "ragged-1+2": (3, [0], [1, 2], 5, 2)}


@pytest.fixture(scope="module")
def pp_runs():
    return {k: _spawn(_pipelined, *v) for k, v in PP_CASES.items()}


@pytest.mark.parametrize("case", list(PP_CASES))
def test_pp_matches_forward_volume(pp_runs, case):
    """The two-stage pipeline (JAX's tests/test_pipeline_parallel.py):
    masks equal and scores within 1e-5 of ``forward_volume``, a ragged N
    (5) with unequal stages padded and cropped; each stage holds only its
    own weights."""
    _, stage_a, stage_b, _, _ = PP_CASES[case]
    for rank, res in enumerate(pp_runs[case]):
        _check_equal(res)
        coarse, sam = res["sizes"]["coarse_model"], res["sizes"]["sam_model"]
        assert (coarse > 0, sam > 0) == (rank in stage_a, rank in stage_b)


def test_pp_refuses_overlapping_stages():
    with pytest.raises(ValueError, match="disjoint"):
        _spawn_free_refusal()


def _spawn_free_refusal():
    """One gloo process: overlapping stages raise before any collective."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method="file://" + tmp + "/r",
                                rank=0, world_size=1)
        try:
            pipe, _ = _tiny()
            PipelinedVolumeRunner(pipe, [0], [0])
        finally:
            dist.destroy_process_group()


# ------------------------------------------------------- sharding, no group


def test_modules_raise_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(n_data=1)
    pipe, _ = _tiny()
    with pytest.raises(RuntimeError, match="process group"):
        PipelinedVolumeRunner(pipe, [0], [1])


def _fake_mesh(n_model, model_rank):
    return sharding.Mesh(1, n_model, 0, model_rank, None, None)


def test_megatron_split_layout():
    """The split of SAM vit_t over 2 model ranks: qkv by heads of q, k
    and v, proj / lin2 / out_proj row-parallel with the whole bias; the
    shards of both ranks put back together give the layer."""
    sam = build_sam("vit_t", image_size=256)
    full = {k: v.clone() for k, v in sam.state_dict().items()}
    halves = []
    for r in range(2):
        part = build_sam("vit_t", image_size=256)
        part.load_state_dict(full)
        plan = encoder_param_sharding(part, _fake_mesh(2, r))
        halves.append(part)
    assert plan["image_encoder.blocks.0.attn.qkv"] == "column"
    assert plan["image_encoder.blocks.0.attn.proj"] == "row"
    assert plan["image_encoder.blocks.0.mlp.lin1"] == "column"
    assert plan["mask_decoder.transformer.layers.0.self_attn.q_proj"] \
        == "column"
    assert plan["mask_decoder.transformer.layers.0.mlp.lin2"] == "row"
    c, nh = 160, 4
    hd = c // nh
    qkv = full["image_encoder.blocks.0.attn.qkv.weight"].reshape(3, nh, hd, c)
    for r, part in enumerate(halves):
        attn = part.image_encoder.blocks[0].attn
        assert attn.num_heads == nh // 2
        torch.testing.assert_close(
            attn.qkv.weight, qkv[:, r * 2:(r + 1) * 2].reshape(-1, c))
        torch.testing.assert_close(
            attn.proj.weight,
            full["image_encoder.blocks.0.attn.proj.weight"][:, r * 80:
                                                            (r + 1) * 80])
        torch.testing.assert_close(
            attn.proj.bias, full["image_encoder.blocks.0.attn.proj.bias"])


@pytest.mark.parametrize("route", ["fused_mlp", "fused_proj", "quant_dense"])
def test_routes_that_take_no_shard(route):
    """Blocks on K7 (fused MLP) or K6 (fused projection) under bf16 stay
    whole, as JAX's Pallas calls get their operands whole under GSPMD; int8
    layers (QuantLinear) stay whole; the rest still splits."""
    sam = build_sam("vit_t", image_size=256, **{route: True})
    if route != "quant_dense":
        sam.image_encoder.to(torch.bfloat16)
    plan = encoder_param_sharding(sam, _fake_mesh(2, 0))
    blk = "image_encoder.blocks.0"
    if route == "fused_mlp":
        assert f"{blk}.mlp.lin1" not in plan and f"{blk}.attn.qkv" in plan
    elif route == "fused_proj":
        assert f"{blk}.attn.qkv" not in plan and f"{blk}.mlp.lin1" in plan
    else:
        assert not any(k.startswith("image_encoder") for k in plan)
        assert isinstance(sam.image_encoder.blocks[0].attn.qkv, QuantLinear)
    # the decoder's layers are plain: they split
    assert "mask_decoder.transformer.layers.0.mlp.lin1" in plan


def test_shard_batch_blocks():
    x = {"a": torch.arange(8), "b": [torch.arange(16).reshape(8, 2)]}
    got = shard_batch(x, sharding.Mesh(4, 1, 2, 0, None, None))
    assert got["a"].tolist() == [4, 5]
    assert got["b"][0].tolist() == [[8, 9], [10, 11]]
    with pytest.raises(ValueError, match="split"):
        shard_batch(torch.arange(6), sharding.Mesh(4, 1, 0, 0, None, None))
