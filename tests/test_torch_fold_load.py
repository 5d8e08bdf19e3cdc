"""The port's fold load (``data/medical.py``) on the CPU: one task a scan
on a thread pool, each file decompressed once.  The pool's dataset equals
the one-thread load's array for array (the native MR ingest, the numpy MR
ingest and CT's, whose statistics take every image first), CT's equals
JAX's, the scans' metadata equals ``read_nii``'s and writes the same
prediction files, the data layer's spans and counts stay in the request
of the span the load began under; and the tracer's side of it: explicit
parents, per-thread tallies and self times that count overlapping
children once."""

import gzip
import json
import os
import sys
import threading
import time

import numpy as np
import pytest

try:  # JAX's dataset, the reference of the CT ingest
    import cv2  # noqa: F401

    from protosam_tpu.data import medical as jmedical
except ImportError:
    pass

import protosam_tpu_torch.native
from protosam_tpu_torch.data import medical, nifti
from protosam_tpu_torch.data.dataset_registry import DATASET_INFO
from protosam_tpu_torch.utils import profiling

DEPTH, SIDE = 5, 24
# spacing, origin and a rotation about z, so every field of the metadata
# is other than its default
SPACING = (1.25, 0.75, 6.5)
ORIGIN = (-12.5, 30.0, 4.25)
DIRECTION = (0.0, -1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0)


def _write_fold(base, dataset: str, scans: int, seed: int = 0):
    """``scans`` scans of ``DEPTH`` x ``SIDE``² as ``dataset`` lays them
    out: float32 images (MR-like or CT Hounsfield-like), int16 labels of
    the dataset's classes, and the class maps."""
    rng = np.random.default_rng(seed)
    names = DATASET_INFO[dataset]["REAL_LABEL_NAME"]
    ct = DATASET_INFO[dataset]["MODALITY"] == "CT"
    classmap = {name: {} for name in names}
    for sid in range(1, scans + 1):
        img = rng.normal(-200.0 if ct else 100.0, 60.0,
                         (DEPTH, SIDE, SIDE)).astype(np.float32)
        lbl = rng.integers(0, 4, (DEPTH, SIDE, SIDE)).astype(np.int16)
        lbl[0] = 0
        for path, arr in ((f"image_{sid}", img), (f"label_{sid}", lbl)):
            nifti.write_nii(nifti.NiftiImage(arr, SPACING, ORIGIN, DIRECTION),
                            os.path.join(base, f"{path}.nii.gz"))
        for cls, name in enumerate(names):
            classmap[name][str(sid)] = sorted(
                int(z) for z in np.unique(np.where(lbl == cls)[0]))
    for fname in ("classmap_1.json", "classmap_100.json"):
        with open(os.path.join(base, fname), "w") as f:
            json.dump(classmap, f)
    return str(base)


@pytest.fixture(scope="module")
def mr_fold(tmp_path_factory):
    return _write_fold(tmp_path_factory.mktemp("mr"), "CHAOST2", 6)


@pytest.fixture(scope="module")
def ct_fold(tmp_path_factory):
    return _write_fold(tmp_path_factory.mktemp("ct"), "SABS", 8, seed=1)


def _load(fold, dataset, monkeypatch, ingest, cpus=None):
    monkeypatch.setattr(protosam_tpu_torch.native, "native_available",
                        lambda: ingest == "native")
    if cpus is not None:
        monkeypatch.setattr(os, "sched_getaffinity",
                            lambda pid: set(range(cpus)))
    ds = medical.MedicalVolumeDataset(dataset, fold, 0, 40)
    monkeypatch.undo()
    return ds


CASES = [("CHAOST2", "native"), ("CHAOST2", "numpy"), ("SABS", "numpy")]


@pytest.mark.parametrize("dataset,ingest", CASES,
                         ids=["mr-native", "mr-numpy", "ct"])
def test_pool_builds_the_serial_dataset(mr_fold, ct_fold, monkeypatch,
                                        dataset, ingest):
    fold = ct_fold if dataset == "SABS" else mr_fold
    calls = protosam_tpu_torch.native.feeder.calls
    serial = _load(fold, dataset, monkeypatch, ingest, cpus=1)
    pooled = _load(fold, dataset, monkeypatch, ingest)
    scans = len(pooled.pid_curr_load)
    assert serial.load_workers == 1
    assert pooled.load_workers == min(scans, len(os.sched_getaffinity(0)))
    assert scans == (7 if dataset == "SABS" else 5)
    # the path asked for ran: three feeder calls a scan on each load
    assert protosam_tpu_torch.native.feeder.calls - calls == (
        6 * scans if ingest == "native" else 0)
    assert [(r.scan_id, r.z_id, r.nframe, r.is_start, r.is_end)
            for r in pooled.actual_dataset] == \
        [(r.scan_id, r.z_id, r.nframe, r.is_start, r.is_end)
         for r in serial.actual_dataset]
    assert len(pooled) == scans * DEPTH
    for a, b in zip(pooled.actual_dataset, serial.actual_dataset):
        for x, y in ((a.img, b.img), (a.lb, b.lb)):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
    assert pooled.scan_z_idx == serial.scan_z_idx
    assert pooled.idx_by_class == serial.idx_by_class
    assert pooled.info_by_scan == serial.info_by_scan


def test_ct_ingest_matches_jax(ct_fold, monkeypatch):
    """CT's images, decoded once for the statistics and handed on to the
    scans' tasks, give JAX's dataset bit for bit (JAX decodes them twice)."""
    ours = _load(ct_fold, "SABS", monkeypatch, "numpy")
    theirs = jmedical.MedicalVolumeDataset("SABS", ct_fold, 0, 40)
    assert ours.scan_z_idx == theirs.scan_z_idx
    assert ours.idx_by_class == theirs.idx_by_class
    for a, b in zip(ours.actual_dataset, theirs.actual_dataset):
        assert (a.scan_id, a.z_id, a.nframe) == (b.scan_id, b.z_id, b.nframe)
        np.testing.assert_array_equal(a.img, b.img)
        np.testing.assert_array_equal(a.lb, b.lb)


@pytest.mark.parametrize("ingest", ["native", "numpy"])
def test_scan_metadata_is_read_niis(mr_fold, monkeypatch, tmp_path, ingest):
    """``info_by_scan`` holds ``read_nii``'s spacing, origin and direction
    and no voxels; a prediction written with it as ``ref`` is the file
    ``read_nii``'s metadata writes."""
    ds = _load(mr_fold, "CHAOST2", monkeypatch, ingest)
    pred = np.random.default_rng(3).random((DEPTH, SIDE, SIDE)).astype(
        np.float32)
    for sid, info in ds.info_by_scan.items():
        want = nifti.read_nii(os.path.join(mr_fold, f"image_{sid}.nii.gz"),
                              peel_info=False)
        assert info.array is None
        assert (info.spacing, info.origin, info.direction) == \
            (want.spacing, want.origin, want.direction)
        np.testing.assert_allclose(info.spacing, SPACING)
        np.testing.assert_allclose(info.origin, ORIGIN)
        np.testing.assert_allclose(info.direction, DIRECTION, atol=1e-7)
        nifti.write_nii(pred, tmp_path / "ours.nii.gz", ref=info)
        nifti.write_nii(pred, tmp_path / "theirs.nii.gz", ref=want)
        assert gzip.decompress((tmp_path / "ours.nii.gz").read_bytes()) == \
            gzip.decompress((tmp_path / "theirs.nii.gz").read_bytes())


@pytest.mark.parametrize("dataset,ingest", CASES,
                         ids=["mr-native", "mr-numpy", "ct"])
def test_load_spans_stay_in_the_request(mr_fold, ct_fold, monkeypatch,
                                        dataset, ingest):
    """Every ``data.*`` span of a load on the pool carries the request of
    the span the load began under, its parent lies inside that request,
    and the bytes and files counted on the pool's threads reach the outer
    span: each file decompressed once (CT's images too, which its
    statistics read first)."""
    fold = ct_fold if dataset == "SABS" else mr_fold
    before = max((s.seq for s in profiling.spans()), default=-1)
    with profiling.span("eval.run") as run:
        with profiling.span("eval.load_fold") as load:
            ds = _load(fold, dataset, monkeypatch, ingest)
    assert ds.load_workers > 1 or len(os.sched_getaffinity(0)) == 1
    new = [s for s in profiling.spans() if s.seq > before]
    data = [s for s in new if s.name.startswith("data.")]
    assert len(data) == 5 * len(ds.pid_curr_load) + 1
    ids = {s.id for s in new if s.request == run.id}
    for s in data:
        assert s.request == run.id and s.parent in ids, s.name
        assert load.start <= s.start and s.end <= load.end
    assert {s.parent for s in data} == {load.id}
    files = [os.path.join(fold, f"{kind}_{sid}.nii.gz")
             for sid in ds.pid_curr_load for kind in ("image", "label")]
    decoded = sum(len(gzip.decompress(open(f, "rb").read())) for f in files)
    for outer in (run, load):
        assert outer.attrs["bytes_decoded"] == decoded
        assert outer.attrs["bytes_read"] == sum(map(os.path.getsize, files))
        assert outer.attrs["files"] == len(files)
    # the counts were made on the tasks' spans, and only there
    assert sum(s.attrs.get("bytes_decoded", 0) for s in data) == decoded


# ------------------------------------------------------------ the tracer


def _hand_made(rec, name, start_ms, end_ms, parent=None):
    with rec.span(name, parent=parent) as s:
        pass
    s.start, s.end = int(start_ms * 1e6), int(end_ms * 1e6)
    return s


@pytest.mark.parametrize("children,self_ms", [
    ([(0, 60), (40, 100)], 0.0),             # overlapping, covering all
    ([(10, 30), (20, 50)], 60.0),            # overlapping, inside
    ([(10, 30), (40, 50), (45, 90)], 30.0),  # one apart, two overlapping
    ([(10, 20), (30, 40)], 80.0),            # apart: the old sum
])
def test_self_time_counts_overlapping_children_once(children, self_ms):
    rec = profiling.Recorder(capacity=16)
    parent = _hand_made(rec, "eval.load_fold", 0, 100)
    kids = [_hand_made(rec, "data.decode", a, b, parent=parent)
            for a, b in children]
    table = profiling.summary([parent] + kids)
    assert table["eval.load_fold"]["self_ms"] == pytest.approx(self_ms)
    assert table["eval.load_fold"]["self_ms"] >= 0
    assert table["data.decode"]["total_ms"] == pytest.approx(
        sum(b - a for a, b in children))


def test_spans_and_tallies_across_threads():
    """More threads than cores open spans under one parent and count, with
    the interpreter switching threads every few µs: every span is kept
    with its own id under the parent's request, and each thread's tally
    holds exactly its own counts while the parent's attributes stay
    untouched by the threads."""
    rec = profiling.Recorder(capacity=4096)
    threads_n, spans_n = 2 * (os.cpu_count() or 1) + 3, 40
    tallies = [None] * threads_n
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with rec.span("eval.load_fold") as parent:
            def work(i):
                with rec.tally() as t:
                    for _ in range(spans_n):
                        with rec.span("data.decode", parent=parent) as s:
                            rec.count("bytes_decoded", i + 1)
                            rec.count("files", 1)
                        assert s.attrs == {"bytes_decoded": i + 1,
                                           "files": 1}
                tallies[i] = t

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(threads_n)]
            t0 = time.monotonic()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=max(1.0, 60 - (time.monotonic() - t0)))
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    kids = [s for s in rec.spans() if s.name == "data.decode"]
    assert len(kids) == threads_n * spans_n == len({s.id for s in kids})
    assert all(s.parent == parent.id and s.request == parent.request
               for s in kids)
    assert tallies == [{"bytes_decoded": (i + 1) * spans_n,
                        "files": spans_n} for i in range(threads_n)]
    assert parent.attrs == {}
    assert rec.current() is None
