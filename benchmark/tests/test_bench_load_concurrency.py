"""The reader ``eval_load_concurrency``: on hand-built span lists (serial
steps read 1, overlapping steps more, spans of the profiled tail and of
other requests left out, None where ``eval_load_share._runs`` finds
nothing) and on the tiny eval cell run traced on the CPU, where it reads
a number, and at most 1.05 with the load held to one thread."""

from __future__ import annotations

import json
import os
import types

import pytest

from benchmark.harness import cell

from bench_tiny import make_root

NAME = "eval_load_concurrency"


def _span(sid, name, start, end, request):
    return types.SimpleNamespace(id=sid, name=name, start=int(start * 1e9),
                                 end=int(end * 1e9), parent=request,
                                 request=request, attrs={}, seq=sid)


def _call(first_id, t0, steps):
    """One call's spans from ``t0`` s: a 4 s load whose ``data.*`` steps
    lie at ``steps`` (offsets into the load, in s)."""
    r = first_id
    out = [_span(r, "eval.run", t0 + 0.2, t0 + 9.9, r),
           _span(r + 1, "eval.load_fold", t0 + 0.2, t0 + 4.2, r),
           _span(r + 2, "eval.score", t0 + 8.5, t0 + 9.5, r)]
    out += [_span(r + 3 + i, "data.decode", t0 + 0.2 + a, t0 + 0.2 + b, r)
            for i, (a, b) in enumerate(steps)]
    return out


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


def test_serial_steps_read_one_and_overlapping_steps_more(program_spans):
    serial = [(0.0, 1.0), (1.0, 2.5), (2.5, 4.0)]
    program_spans += _call(1, 100.0, serial) + _call(20, 110.0, serial)
    m = _measured([(100.0, 110.0), (110.0, 120.0)])
    assert cell.read_metric(NAME, m) == pytest.approx(1.0)
    # five scans' steps at once over the first call's load, 4 s each
    program_spans[:] = _call(1, 100.0, [(0.0, 4.0)] * 5) \
        + _call(20, 110.0, serial)
    assert cell.read_metric(NAME, m) == pytest.approx((20.0 + 4.0) / 8.0)


def test_tail_and_other_requests_stay_out(program_spans):
    program_spans += _call(1, 100.0, [(0.0, 2.0)])
    # the profiled tail after the window, and a request outside any call
    program_spans += _call(20, 130.0, [(0.0, 4.0)] * 8)
    program_spans += [_span(40, "data.decode", 101.0, 103.0, 40)]
    m = _measured([(100.0, 110.0)])
    assert cell.read_metric(NAME, m) == pytest.approx(0.5)


def test_none_where_the_runs_give_none(program_spans, monkeypatch):
    from protosam_tpu_torch.utils import profiling

    m = _measured([(100.0, 110.0)])
    assert cell.read_metric(NAME, m) is None
    program_spans += _call(1, 100.0, [(0.0, 4.0)])
    assert cell.read_metric(NAME, _measured([(100.0, 110.0)],
                                            "volumes")) is None
    monkeypatch.setattr(profiling, "dropped", lambda: 5)
    assert cell.read_metric(NAME, m) is None


@pytest.mark.parametrize("cpus", [None, 1], ids=["pool", "one-thread"])
def test_tiny_eval_cell_reports_the_concurrency(tmp_path, monkeypatch,
                                                cpus):
    from protosam_tpu_torch.eval import protosam_eval

    root = make_root(tmp_path)
    b = json.loads((root / "BENCHMARK.json").read_text())
    spec = next(m for m in cell.manifest()["per_layer"] if m["name"] == NAME)
    b["per_layer"].append(dict(spec, workloads=["t.ev"]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(protosam_eval, "SAM_IMAGE_SIZE", 256)
    if cpus is not None:
        monkeypatch.setattr(os, "sched_getaffinity",
                            lambda pid: set(range(cpus)))
    res, _, _ = cell.run("t.ev", 2**31 + 11, 0.01, True, 0.0, device="cpu",
                         root=root)
    got = res["metrics"][NAME]
    assert got["unit"] == "x"
    assert got["value"] > 0.5
    if cpus == 1:
        assert got["value"] <= 1.05
