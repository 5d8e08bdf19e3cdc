"""The port's tracer (``protosam_tpu_torch/utils/profiling.py``) on the
CPU: spans, their parents, request ids and counts, the ring's bound, no
range or CUDA event while tracing is off, the ranges a CPU
``torch.profiler`` trace holds, the span tree of ``run_eval`` on a
synthetic CHAOS-T2 fold (``tests/synthetic_data.py``; dinov2_t14 at 64 px
+ SAM vit_t at a 256 frame, f32), and outputs bit-equal with tracing on
and off."""

import collections
import gzip
import json
import os
import re

import pytest
import torch

try:  # writes the fold with the JAX package's NIfTI writer
    from tests.synthetic_data import HW, make_dataset
except ImportError:
    pass

from torch_parity import seeded_state_dict

import protosam_tpu_torch.native
from protosam_tpu_torch.eval import protosam_eval
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.native import feeder
from protosam_tpu_torch.ops import tables
from protosam_tpu_torch.utils import profiling
from protosam_tpu_torch.utils.config import Config
from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                synthetic_episode)

torch.set_num_threads(2)

SAM_FRAME = 256
PIPELINE_STAGES = ("pipeline.coarse", "pipeline.prompts",
                   "pipeline.sam_encoder", "pipeline.decode")


# ------------------------------------------------------------ the tracer


def test_spans_nest_with_parents_requests_and_counts():
    rec = profiling.Recorder(capacity=16)
    with rec.span("eval.run", mode="volume") as run:
        with rec.span("eval.load_fold") as load:
            with rec.span("data.decode", file="a") as dec:
                rec.count("bytes_decoded", 10)
            with rec.span("data.decode", file="b"):
                rec.count("bytes_decoded", 5)
        run.attrs["slices"] = 3
    with rec.span("pipeline.volume") as vol:
        pass
    assert (run.parent, run.request) == (0, run.id)
    assert (load.parent, load.request) == (run.id, run.id)
    assert (dec.parent, dec.request) == (load.id, run.id)
    assert (vol.parent, vol.request) == (0, vol.id) and vol.id != run.id
    # counts land on the span open where the work happened and those
    # around it; keyword attributes stay
    assert dec.attrs == {"file": "a", "bytes_decoded": 10}
    assert load.attrs == {"bytes_decoded": 15}
    assert run.attrs == {"mode": "volume", "bytes_decoded": 15,
                         "slices": 3}
    got = rec.spans()
    assert [s.name for s in got] == ["eval.run", "eval.load_fold",
                                     "data.decode", "data.decode",
                                     "pipeline.volume"]
    assert all(s.start <= s.end for s in got)
    assert run.start <= load.start <= dec.start and dec.end <= load.end \
        <= run.end < vol.start
    assert rec.spans(within=load) == got[1:4]
    assert rec.spans(within=run) == got[:4]
    table = profiling.summary(got[:4])
    assert table["data.decode"]["count"] == 2
    ms = {s.id: s.duration_ns() / 1e6 for s in got}
    assert table["eval.load_fold"]["self_ms"] == pytest.approx(
        ms[load.id] - table["data.decode"]["total_ms"])
    assert table["eval.run"]["self_ms"] == pytest.approx(
        ms[run.id] - ms[load.id])
    assert not any("device_ms" in row for row in table.values())
    assert "eval.run" in profiling.report(table)


def test_summary_sums_the_counts_on_the_spans():
    """``summary`` adds up each name's numeric attributes (a dict of
    them under ``<key>.<its key>``), leaves strings and flags out, and
    ``report`` prints them."""
    rec = profiling.Recorder(capacity=16)
    for n, pad, k1 in ((8, 0, 96), (5, 3, 96)):
        with rec.span("pipeline.volume", slices=n, padded=pad,
                      mode="volume", warm=True) as vol:
            with rec.span("pipeline.coarse"):
                pass
            vol.attrs["launches"] = {"K1": k1, "K3": 1}
    table = profiling.summary(rec.spans())
    assert table["pipeline.volume"]["counts"] == {
        "slices": 13, "padded": 3, "launches.K1": 192, "launches.K3": 2}
    assert "counts" not in table["pipeline.coarse"]
    line = profiling.report(table).splitlines()[0]
    assert line.startswith("pipeline.volume: ")
    assert line.endswith(" launches.K1=192 launches.K3=2 padded=3 slices=13")


def test_ring_keeps_the_newest_and_counts_what_it_dropped():
    assert profiling.CAPACITY == 65536
    rec = profiling.Recorder(capacity=8)
    for i in range(20):
        with rec.span("eval.step", i=i):
            pass
    assert [s.attrs["i"] for s in rec.spans()] == list(range(12, 20))
    assert rec.dropped() == 12
    # a span that raises is recorded and the error goes on
    with pytest.raises(ValueError):
        with rec.span("eval.fails"):
            raise ValueError
    assert rec.spans()[-1].name == "eval.fails" and rec.dropped() == 13
    assert rec._stack() == []
    rec.clear()
    assert rec.spans() == [] and rec.dropped() == 0
    with rec.span("eval.after"):
        pass
    assert len(rec.spans()) == 1 and rec.dropped() == 0


def test_resnet_forward_leaves_its_encode_and_stage_spans(monkeypatch):
    """One ``resnet.encode`` span a forward (its images, the 105
    convolutions of the published trunk, the output grid's side, the 104
    BatchNorms folded on the first call and none on the next) over six
    ``resnet.stage`` spans, stem to localconv."""
    from protosam_tpu_torch.models.backbones.resnet import \
        DeeplabRes101Encoder

    rec = profiling.Recorder(capacity=64)
    monkeypatch.setattr(profiling, "span", rec.span)
    monkeypatch.setattr(profiling, "count", rec.count)
    enc = DeeplabRes101Encoder().eval()
    with torch.no_grad():
        enc(torch.zeros(3, 3, 32, 32))
    got = rec.spans()
    assert [s.name for s in got] == ["resnet.encode"] + ["resnet.stage"] * 6
    encode, stages = got[0], got[1:]
    assert encode.attrs == {"images": 3, "convs": 105, "feature_hw": 4,
                            "bn_folds": 104}
    assert [s.attrs["stage"] for s in stages] == [
        "stem", "layer1", "layer2", "layer3", "layer4", "localconv"]
    assert all(s.parent == encode.id for s in stages)
    assert profiling.summary(got)["resnet.encode"]["counts"] == {
        "images": 3, "convs": 105, "feature_hw": 4, "bn_folds": 104}
    rec.clear()
    with torch.no_grad():
        enc(torch.zeros(3, 3, 32, 32))
    assert rec.spans()[0].attrs == {"images": 3, "convs": 105,
                                    "feature_hw": 4, "bn_folds": 0}


def test_tracing_off_opens_no_range_and_makes_no_cuda_event(monkeypatch):
    ranges, events = [], []

    class Range:
        def __init__(self, name):
            ranges.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.recorded = []
            events.append(self)

        def record(self, stream):
            self.recorded.append(stream)

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 2.5

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    card = torch.device("cuda", 0)
    rec = profiling.Recorder()
    with rec.span("pipeline.decode", device=card):
        with rec.span("eval.score"):
            pass
    assert ranges == [] and events == []
    assert profiling.summary(rec.spans())["pipeline.decode"].get(
        "device_ms") is None

    rec.enabled = True
    with rec.span("pipeline.decode", device=card):
        with rec.span("eval.score", device=torch.device("cpu")):
            pass
    assert ranges == ["protosam.pipeline/decode", "protosam.eval/score"]
    # an event pair for the span on the card, none for the host's
    assert len(events) == 2
    assert [e.recorded for e in events] == [["stream"], ["stream"]]
    table = profiling.summary(rec.spans()[2:])
    assert table["pipeline.decode"]["device_ms"] == 2.5
    assert "device_ms" not in table["eval.score"]
    assert not profiling.enabled()  # the process-wide recorder is off


# ------------------------------------------------------------- run_eval


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("chaos")))


def _cfg(data_dir):
    cfg = Config()
    cfg.dataset = "CHAOST2"
    cfg.data_dirs = {"CHAOST2": data_dir}
    cfg.input_size = (HW, HW)
    cfg.modelname = "dinov2_t14"
    cfg.protosam_sam_ver = "vit_t"
    cfg.curr_cls = "rk"
    cfg.do_cca = True
    cfg.support_idx = [-1]
    cfg.dtype = "float32"
    cfg.slice_batch = 2
    cfg.max_ccs = 4
    cfg.log_dir = ""
    return cfg


@pytest.fixture(scope="module")
def pipe():
    coarse = FewShotSeg(image_size=HW, which_model="dinov2_t14")
    sam = build_sam("vit_t", image_size=SAM_FRAME)
    mp = pytest.MonkeyPatch()
    mp.setattr(protosam_eval, "SAM_IMAGE_SIZE", SAM_FRAME)
    try:
        return protosam_eval.build_models(
            _cfg(""), device="cpu", coarse_state=seeded_state_dict(coarse, 0),
            sam_state=seeded_state_dict(sam, 1))
    finally:
        mp.undo()


def _last_run() -> profiling.Span:
    return next(s for s in reversed(profiling.spans())
                if s.name == "eval.run")


def _decoded_bytes(path) -> int:
    with gzip.open(path, "rb") as f:
        return len(f.read())


@pytest.mark.parametrize("ingest", ["native", "numpy"])
def test_run_eval_spans_follow_the_driver(data_dir, pipe, monkeypatch,
                                          ingest):
    """One ``eval.run`` whose children are the driver's steps in order,
    the data layer's spans under ``eval.load_fold`` with the bytes its
    files decode to, and every span of the call under the run's id."""
    if ingest == "numpy":
        monkeypatch.setattr(protosam_tpu_torch.native, "native_available",
                            lambda: False)
    native_calls = feeder.calls
    result = protosam_eval.run_eval(_cfg(data_dir), pipe=pipe,
                                    profile=True)
    native = feeder.calls > native_calls
    assert native == (ingest == "native"
                      and protosam_tpu_torch.native.native_available())
    run = _last_run()
    tree = profiling.spans(within=run)
    assert tree[0] is run and all(s.request == run.id for s in tree)
    children = [s for s in tree if s.parent == run.id]
    names = [s.name for s in children]
    chunks = (len(names) - 4) // 3
    assert chunks == 3
    assert names == (["eval.load_fold", "eval.support",
                      "eval.gather_queries"]
                     + ["eval.to_device", "eval.segment", "eval.score"]
                     * chunks + ["eval.detection"])

    load = children[0]
    data = [s for s in tree if s.parent == load.id]
    # each scan's task: its image decoded, preprocessed, its label decoded
    # and resized, in that order on one thread; then, back on this
    # thread and in scan order, its slice records; last the class files
    assert data[-1].name == "data.index" and "scan" not in data[-1].attrs
    by_scan = {}
    for s in data[:-1]:
        sid = s.attrs.get("scan") or re.findall(r"\d+", s.attrs["file"])[-1]
        by_scan.setdefault(sid, []).append(s.name)
    scans = sorted(by_scan, key=int)
    for names in by_scan.values():
        assert names == ["data.decode", "data.preprocess", "data.decode",
                         "data.labels", "data.index"]
    index = [s for s in data[:-1] if s.name == "data.index"]
    assert [s.attrs["scan"] for s in index] == scans
    assert min(s.start for s in index) >= max(
        s.end for s in data if s.name != "data.index")
    assert load.attrs["scans"] == len(scans) == 5
    assert load.attrs["workers"] == min(5, len(os.sched_getaffinity(0)))
    # every file is decompressed once, on either path, and the counts made
    # on the pool's threads reach the load's span
    want = sum(_decoded_bytes(os.path.join(data_dir, f"{kind}_{sid}.nii.gz"))
               for sid in scans for kind in ("image", "label"))
    assert load.attrs["bytes_decoded"] == want
    assert load.attrs["bytes_read"] == sum(
        os.path.getsize(os.path.join(data_dir, f"{kind}_{sid}.nii.gz"))
        for sid in scans for kind in ("image", "label"))
    assert load.attrs["files"] == 2 * len(scans)
    assert sum(s.attrs.get("bytes_decoded", 0) for s in data) == want
    if native:  # the image's parse and preprocess, the label's parse
        assert feeder.calls - native_calls == 3 * len(scans)

    n = result["n_slices"]
    gather = children[2]
    assert run.attrs["slices"] == n == gather.attrs["kept"] > 0
    assert n + gather.attrs["skipped_support"] \
        + gather.attrs["skipped_no_organ"] == 6 * len(scans)
    assert sum(s.attrs["slices"] for s in children
               if s.name == "eval.segment") == n
    assert result["slices_per_sec"] == pytest.approx(
        n / (run.duration_ns() / 1e9))

    # each chunk's segment holds one volume, whose stages ran per batch
    volumes = [s for s in tree if s.name == "pipeline.volume"]
    assert [v.parent for v in volumes] == [s.id for s in children
                                          if s.name == "eval.segment"]
    assert sum(v.attrs["slices"] for v in volumes) == n
    assert all(v.attrs["launches"] == {} for v in volumes)  # no card
    batches = sum(-(-v.attrs["slices"] // 2) for v in volumes)
    for stage in PIPELINE_STAGES:
        assert sum(s.name == stage for s in tree) == batches, stage
    table = result["trace"]
    assert table["eval.run"]["count"] == 1
    assert table["eval.segment"]["count"] == chunks
    assert set(table) == {s.name for s in tree}
    # the counts reach the call's trace
    assert table["eval.load_fold"]["counts"]["bytes_decoded"] == want
    assert table["eval.gather_queries"]["counts"]["kept"] == n
    assert table["pipeline.volume"]["counts"] == {
        "slices": n, "padded": sum(v.attrs["padded"] for v in volumes),
        "tables": sum(v.attrs["tables"] for v in volumes)}


def test_run_eval_span_leaves_out_building_the_pipeline(data_dir, pipe,
                                                        monkeypatch):
    """``run_eval`` without a pipeline builds it before ``eval.run``
    opens, so neither the span nor ``slices_per_sec`` holds the build."""
    open_at_build = []

    def build(cfg):
        open_at_build.append([s.name for s in profiling._recorder._stack()])
        return pipe

    monkeypatch.setattr(protosam_eval, "build_models", build)
    before = max((s.seq for s in profiling.spans()), default=-1)
    protosam_eval.run_eval(_cfg(data_dir))
    assert open_at_build == [[]]
    runs = [s for s in profiling.spans()
            if s.name == "eval.run" and s.seq > before]
    assert len(runs) == 1


def test_cpu_profiler_trace_holds_the_program_ranges(data_dir, pipe,
                                                     tmp_path):
    """With tracing off, a ``torch.profiler`` session alone opens the
    program's ranges, named ``protosam.<layer>/<what>``; one that profiles
    every thread also holds the fold's load tasks' ranges."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    assert not profiling.enabled()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        protosam_eval.run_eval(_cfg(data_dir), pipe=pipe)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name", "") for e in
             json.loads(path.read_text())["traceEvents"]}
    for name in ("protosam.eval/run", "protosam.eval/load_fold",
                 "protosam.eval/segment", "protosam.data/preprocess",
                 "protosam.data/decode", "protosam.data/labels",
                 "protosam.data/index", "protosam.pipeline/volume",
                 "protosam.pipeline/coarse", "protosam.pipeline/decode"):
        assert name in names, name
    # outside the session no range is opened
    with profiling.span("eval.outside") as s:
        assert s._range is None


def _volume_inputs():
    return smooth_volume(3, HW, seed=4), synthetic_episode(HW, "cpu", 5)


@pytest.mark.parametrize("slice_batch", [2, 3])
def test_forward_volume_is_bit_equal_with_tracing_on_and_off(pipe,
                                                             slice_batch):
    vol, inp = _volume_inputs()
    off = pipe.forward_volume(vol, inp, slice_batch=slice_batch)
    profiling.enable()
    try:
        on = pipe.forward_volume(vol, inp, slice_batch=slice_batch)
    finally:
        profiling.enable(False)
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    volume = next(s for s in reversed(profiling.spans())
                  if s.name == "pipeline.volume")
    assert volume.attrs["padded"] == (-3) % slice_batch
    assert volume.attrs["slices"] == 3


def test_volume_span_counts_the_tables_built(pipe, monkeypatch):
    """``tables`` on ``pipeline.volume``: the shape-only tables the call
    built, some on a first call, none on a second of the same shapes."""
    monkeypatch.setattr(tables, "_tables", collections.OrderedDict())
    vol, inp = _volume_inputs()
    built = []
    for _ in range(2):
        pipe.forward_volume(vol, inp, slice_batch=2)
        built.append(next(s for s in reversed(profiling.spans())
                          if s.name == "pipeline.volume").attrs["tables"])
    assert built[0] > 0 and built[1] == 0


@pytest.mark.parametrize("mode", ["volume", "per_slice"])
def test_run_eval_metrics_are_equal_with_tracing_on_and_off(data_dir, pipe,
                                                            mode):
    off = protosam_eval.run_eval(_cfg(data_dir), pipe=pipe, mode=mode)
    profiling.enable()
    try:
        on = protosam_eval.run_eval(_cfg(data_dir), pipe=pipe, mode=mode)
    finally:
        profiling.enable(False)
    for r in (on, off):
        r.pop("slices_per_sec")
    assert on == off and on["n_slices"] > 0
    run = _last_run()
    assert run.attrs["mode"] == mode
    stages = [s for s in profiling.spans(within=run)
              if s.name in PIPELINE_STAGES]
    assert stages and all(s.request == run.id for s in stages)
