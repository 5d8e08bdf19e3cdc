"""The port's utilities against the JAX package on the CPU: the decoder
export (``torch.export``), the prefetch, the agreement harness, the legacy
helpers, the debugging tools and the golden-replay tool.  The prefetch's
card path (pinned memory, a side stream) is a ``cuda`` test."""

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import jax.numpy as jnp

    from protosam_tpu.data.nifti import NiftiImage, write_nii
    from protosam_tpu.data.prefetch import VolumePrefetcher as JPrefetcher
    from protosam_tpu.data.prefetch import device_prefetch as jprefetch
    from protosam_tpu.utils import agreement as jagreement
    from protosam_tpu.utils import legacy as jlegacy
    from protosam_tpu.utils.debugging import \
        assert_finite_tree as jassert_finite
except ImportError:
    pass

from protosam_tpu_torch.data.prefetch import VolumePrefetcher, device_prefetch
from protosam_tpu_torch.tools import replay_goldens
from protosam_tpu_torch.utils import agreement, debugging, legacy
from protosam_tpu_torch.utils.export import export_decoder, load_exported
from protosam_tpu_torch.utils.synthetic import seeded_tiny_sam

torch.set_num_threads(2)


# ---------------------------------------------------------------- export


def test_exported_decoder_round_trip_equals_decode():
    """The serialized program, reloaded, gives ``Sam.decode``'s outputs
    exactly (f32, CPU; the same operators on the same inputs)."""
    sam = seeded_tiny_sam()
    blob = export_decoder(sam, num_points=2, multimask_output=True)
    assert isinstance(blob, bytes)
    fn = load_exported(blob)
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.standard_normal(
        (1, 256, 16, 16)).astype(np.float32))
    coords = torch.from_numpy((rng.random((1, 2, 2)) * 256).astype(
        np.float32))
    labels = torch.tensor([[1, 0]], dtype=torch.int32)
    boxes = torch.tensor([[20.0, 30.0, 150.0, 170.0]])
    with torch.no_grad():
        got = fn(emb, coords, labels, boxes)
        want = sam.decode(emb, coords, labels, boxes, None, True, False)
    assert got[0].shape == (1, 3, 64, 64) and got[1].shape == (1, 3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # the decoder's LayerNorms are K1's opaque op; no encoder weights
    program = torch.export.load(__import__("io").BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes]
    assert sum("ptk.layer_norm_rows" in t for t in targets) == 9
    assert not any(k.startswith("image_encoder") or ".image_encoder." in k
                   for k in program.state_dict)


# -------------------------------------------------------------- prefetch


def test_device_prefetch_order_and_device_match_jax():
    batches = [{"x": np.full((4,), i, np.float32),
                "y": (np.arange(3) + i, [np.float32(i)])} for i in range(5)]
    out = list(device_prefetch(iter(batches), size=2, device="cpu"))
    want = list(jprefetch(iter(batches), size=2))
    assert len(out) == len(want) == 5
    for i, (b, w) in enumerate(zip(out, want)):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == \
            "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), np.asarray(w["x"]))
        np.testing.assert_array_equal(b["y"][0].numpy(),
                                      np.asarray(w["y"][0]))
        assert float(b["y"][1][0]) == float(w["y"][1][0]) == i


def test_volume_prefetcher_matches_jax():
    def produce(i):
        return None if i >= 3 else np.full((2, 2), i, np.float32)

    out = list(VolumePrefetcher(produce, n_steps=10, depth=2, device="cpu"))
    want = list(JPrefetcher(produce, n_steps=10, depth=2))
    assert len(out) == len(want) == 3
    for b, w in zip(out, want):
        np.testing.assert_array_equal(b.numpy(), np.asarray(w))


@pytest.mark.cuda
def test_prefetch_on_the_card_in_order():
    """The card path: pinned staging, copies on a side stream, the
    consumer's stream made to wait; values and order as on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the prefetch's card path")
    batches = [np.full((256, 1024), i, np.float32) for i in range(6)]
    for out in (list(device_prefetch(iter(batches), size=2)),
                list(VolumePrefetcher(lambda i: batches[i] if i < 6 else
                                      None, n_steps=10))):
        assert [b.device.type for b in out] == ["cuda"] * 6
        for i, b in enumerate(out):
            assert float((b * 2).sum()) == 2.0 * i * b.numel()


# ------------------------------------------------------------- agreement


def test_dice_and_agreement_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    assert agreement.dice(np.zeros((4, 4)), np.zeros((4, 4))) == 1.0
    for _ in range(3):
        a, b = rng.random((8, 8)) > 0.5, rng.random((8, 8)) > 0.4
        assert agreement.dice(a, b) == jagreement.dice(a, b)

    ours, ref = tmp_path / "ours", tmp_path / "ref"
    ours.mkdir(), ref.mkdir()
    m = (rng.random((3, 16, 16)) > 0.6).astype(np.uint8)
    for d in (ours, ref):
        write_nii(NiftiImage(m, (1, 1, 1)), d / "scan_1_label_2.nii.gz")
    m2 = m.copy()
    m2[0, 0, 0] ^= 1
    write_nii(NiftiImage(m, (1, 1, 1)), ours / "scan_2_label_2.nii.gz")
    write_nii(NiftiImage(m2, (1, 1, 1)), ref / "scan_2_label_2.nii.gz")
    write_nii(NiftiImage(m, (1, 1, 1)), ours / "scan_3_label_2.nii.gz")
    np.save(ours / "slice_0.npy", m[0])
    np.save(ref / "slice_0.npy", m2[0])
    for pattern in ("*.nii.gz", "*.npy"):
        got = agreement.dice_agreement_report(str(ours), str(ref), pattern)
        want = jagreement.dice_agreement_report(str(ours), str(ref), pattern)
        assert got == want
    rep = agreement.dice_agreement_report(str(ours), str(ref))
    assert rep["n_pairs"] == 2 and rep["missing_in_reference"] == \
        ["scan_3_label_2.nii.gz"]
    assert 0.98 < rep["per_scan"]["scan_2_label_2.nii.gz"] < 1.0


# ---------------------------------------------------------------- legacy


@pytest.mark.parametrize("window,threshold", [(3, 0.5), (5, 0.45), (4, 0.5)])
def test_sliding_window_segmentation_matches_jax(window, threshold):
    conf = np.random.default_rng(window).random((2, 12, 17)).astype(
        np.float32)
    got = legacy.sliding_window_confidence_segmentation(
        torch.from_numpy(conf), window, threshold)
    want = jlegacy.sliding_window_confidence_segmentation(
        jnp.asarray(conf), window, threshold)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_choose_threshold_kneedle_matches_jax():
    rng = np.random.default_rng(2)
    for p in (rng.beta(0.5, 3.0, 500), rng.random(50), np.array([0.3]),
              np.array([]), rng.beta(2.0, 2.0, 2000)):
        assert legacy.choose_threshold_kneedle(p) == \
            jlegacy.choose_threshold_kneedle(p)


# ------------------------------------------------------------- debugging


def test_assert_finite_tree_matches_jax():
    ok = {"a": torch.ones(3), "b": {"c": torch.zeros(2)},
          "d": [torch.arange(3), (torch.ones(1),)]}
    debugging.assert_finite_tree(ok)
    jassert_finite({"a": jnp.ones(3), "b": {"c": jnp.zeros(2)}})
    for bad_value in (np.nan, np.inf):
        bad = {"a": torch.ones(3),
               "b": {"c": torch.tensor([1.0, bad_value])}}
        with pytest.raises(FloatingPointError, match=r"params.*\['b'\]"):
            debugging.assert_finite_tree(bad, "params")
        with pytest.raises(FloatingPointError):
            jassert_finite({"a": jnp.ones(3),
                            "b": {"c": jnp.asarray([1.0, bad_value])}},
                           "params")


def test_checked_and_nan_checks():
    g = debugging.checked(lambda x: torch.log(x))
    torch.testing.assert_close(g(torch.tensor([1.0, 2.0])),
                               torch.log(torch.tensor([1.0, 2.0])))
    with pytest.raises(FloatingPointError):
        g(torch.tensor([-1.0]))
    debugging.enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()  # NaN in the backward
    finally:
        debugging.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_set_deterministic():
    debugging.set_deterministic(True)
    try:
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        debugging.set_deterministic(False)
    assert not torch.are_deterministic_algorithms_enabled()


# ---------------------------------------------------------- golden replay


def test_replay_goldens_tool_on_the_cpu(tmp_path):
    """The card's replay tool, here on the CPU (plain versions): JAX's
    bars on two recorded configurations, and its JSON file."""
    out = tmp_path / "replay.json"
    rc = replay_goldens.main(["--device", "cpu", "--configs", "cca,neg",
                              "--out", str(out)])
    assert rc == 0
    result = __import__("json").loads(out.read_text())
    assert set(result["configs"]) == {"cca", "neg"} and result["passes"]
    for row in result["configs"].values():
        assert row["f32_vs_reference"]["min"] >= 0.99
        assert row["bf16_vs_reference"]["min"] >= 0.97
