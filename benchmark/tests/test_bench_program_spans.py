"""The readers of the program's own spans (``eval_load_share``,
``eval_queries_share``, ``eval_score_share``,
``eval_decoded_mb_per_slice``): on a hand-built ``Measured`` and span
list, spans outside the window's calls ignored, None without spans or
without a tracer in the program, and on the tiny eval cell run traced on
the CPU."""

from __future__ import annotations

import json
import types

import pytest

from benchmark.harness import cell

from bench_tiny import make_root

READERS = ("eval_load_share", "eval_queries_share", "eval_score_share",
           "eval_decoded_mb_per_slice")


def _span(sid, name, start, end, request, **attrs):
    return types.SimpleNamespace(id=sid, name=name, start=int(start * 1e9),
                                 end=int(end * 1e9), parent=request,
                                 request=request, attrs=attrs, seq=sid)


def _call(first_id, t0, decoded, slices):
    """One ``run_eval`` call's spans from ``t0`` s: 10 s in all (0.2 s
    before the run span opens, 0.1 s after it closes)."""
    r = first_id
    return [
        _span(r, "eval.run", t0 + 0.2, t0 + 9.9, r, slices=slices),
        _span(r + 1, "eval.load_fold", t0 + 0.2, t0 + 4.2, r,
              bytes_decoded=decoded),
        _span(r + 2, "data.decode", t0 + 0.3, t0 + 1.3, r,
              bytes_decoded=decoded),
        _span(r + 3, "eval.support", t0 + 4.2, t0 + 4.3, r),
        _span(r + 4, "eval.gather_queries", t0 + 4.3, t0 + 5.2, r),
        _span(r + 5, "eval.to_device", t0 + 5.2, t0 + 5.5, r),
        _span(r + 6, "eval.segment", t0 + 5.5, t0 + 8.5, r),
        _span(r + 7, "pipeline.volume", t0 + 5.5, t0 + 8.4, r),
        _span(r + 8, "eval.score", t0 + 8.5, t0 + 9.5, r),
        _span(r + 9, "eval.detection", t0 + 9.5, t0 + 9.9, r),
    ]


def _measured(call_spans, driver="eval"):
    return cell.Measured({}, {"driver": driver}, 1.0, 20.0, 2, 176, {}, {},
                         None, [], call_spans)


@pytest.fixture
def program_spans(monkeypatch):
    from protosam_tpu_torch.utils import profiling

    spans = []
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    return spans


def test_readers_on_hand_built_spans(program_spans):
    # two calls in the window, and a call of the profiled tail after it
    # whose spans must not count
    program_spans += _call(1, 100.0, 8e8, 88) + _call(20, 110.0, 6e8, 88)
    program_spans += _call(40, 130.0, 5e9, 1)
    m = _measured([(100.0, 110.0), (110.0, 120.0)])
    got = {name: cell.read_metric(name, m) for name in READERS}
    # shares of the calls' 20 s of wall: load 4 s + 4 s, queries
    # 1.3 s + 1.3 s, score 1.4 s + 1.4 s
    assert got["eval_load_share"] == pytest.approx(40.0)
    assert got["eval_queries_share"] == pytest.approx(13.0)
    assert got["eval_score_share"] == pytest.approx(14.0)
    # 1.4e9 bytes over 176 slices; the data span's own count is not added
    assert got["eval_decoded_mb_per_slice"] == pytest.approx(1400 / 176)


def test_readers_keep_only_runs_inside_the_calls(program_spans):
    program_spans += _call(1, 100.0, 8e8, 88) + _call(20, 110.0, 6e8, 88)
    # the second call's run span is not inside any call of the window, so
    # that call's wall and spans stay out
    m = _measured([(100.0, 110.0), (110.5, 119.0)])
    assert cell.read_metric("eval_load_share", m) == pytest.approx(40.0)
    assert cell.read_metric("eval_decoded_mb_per_slice", m) == \
        pytest.approx(800 / 88)


def test_readers_give_none_where_the_ring_dropped_spans_of_a_call(
        program_spans, monkeypatch):
    from protosam_tpu_torch.utils import profiling

    program_spans += _call(1, 100.0, 8e8, 88) + _call(20, 110.0, 6e8, 88)
    m = _measured([(100.0, 110.0), (110.0, 120.0)])
    monkeypatch.setattr(profiling, "dropped", lambda: 3)
    # the oldest span left (the first call's run, by ``seq``) ended after
    # the first run began: its children may be gone
    for name in READERS:
        assert cell.read_metric(name, m) is None, name
    # spans dropped before the window's first run are no loss
    del program_spans[:10]
    m = _measured([(110.0, 120.0)])
    program_spans += [_span(0, "eval.earlier", 90.0, 95.0, 0)]
    assert cell.read_metric("eval_load_share", m) == pytest.approx(40.0)


def test_readers_give_none_without_spans(program_spans, monkeypatch):
    m = _measured([(100.0, 110.0)])
    for name in READERS:
        assert cell.read_metric(name, m) is None, name
    # spans, but none inside the window's calls
    program_spans += _call(1, 200.0, 8e8, 88)
    for name in READERS:
        assert cell.read_metric(name, m) is None, name
    # not an eval cell, or no calls
    program_spans += _call(20, 100.0, 8e8, 88)
    for name in READERS:
        assert cell.read_metric(name, _measured([(100.0, 110.0)],
                                                "volumes")) is None
        assert cell.read_metric(name, _measured([])) is None
    # a program without a tracer (no ``profiling.spans``)
    from protosam_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    for name in READERS:
        assert cell.read_metric(name, m) is None, name


def test_tiny_eval_cell_reports_the_program_spans(tmp_path, monkeypatch):
    """The tiny eval cell, run traced on the CPU with the four metrics in
    its manifest, reports them; the decoded bytes are what the fold's
    files decompress to."""
    from protosam_tpu_torch.eval import protosam_eval

    root = make_root(tmp_path)
    b = json.loads((root / "BENCHMARK.json").read_text())
    manifest = cell.manifest()
    b["per_layer"] += [dict(m, workloads=["t.ev"])
                       for m in manifest["per_layer"]
                       if m["name"] in READERS]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(protosam_eval, "SAM_IMAGE_SIZE", 256)
    res, _, earlier = cell.run("t.ev", 7, 0.01, True, 0.0, device="cpu",
                               root=root)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(got)
    shares = [got[k] for k in READERS[:3]]
    assert all(0.0 < s < 100.0 for s in shares)
    assert sum(shares) < got["eval_host_share"]
    traffic = earlier[1]["traffic"]
    fold = json.loads((root / "benchmark/traffic/ev.json").read_text())
    scans, depth, side = (len(fold["fold"]["scan_ids"]),
                          fold["fold"]["depth"], fold["fold"]["side"])
    image, label = depth * side * side * 4, depth * side * side * 2
    # each file is inflated once, to its 352 header bytes and its voxels
    decoded = scans * (352 + image + 352 + label)
    assert got["eval_decoded_mb_per_slice"] == pytest.approx(
        decoded / 1e6 / (traffic["slices"] / traffic["calls"]))
