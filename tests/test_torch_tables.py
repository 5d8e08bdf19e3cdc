"""Shape-only tables (``protosam_tpu_torch/ops/tables.py``): each site's
cached table bit-equal to the table its call built before the cache, one
build per key and device, the bound on the tables kept, and
``forward_volume`` bit-equal with the cache cold, warm and off.  The
``cuda`` test runs a warm ``forward_volume`` under
``torch.cuda.set_sync_debug_mode("error")``: no stream sync from its first
launch to its return."""

import collections
import sys
import threading

import numpy as np
import pytest
import torch

from protosam_tpu_torch.entry import build_pipeline
from protosam_tpu_torch.models.sam.image_encoder import rel_pos_table
from protosam_tpu_torch.models.sam.prompt_encoder import PromptEncoder
from protosam_tpu_torch.models.sam.sam import preprocess
from protosam_tpu_torch.ops import resize, tables
from protosam_tpu_torch.ops.tables import device_table
from protosam_tpu_torch.pipeline.protosam import ProtoSAMConfig
from protosam_tpu_torch.utils import profiling
from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                synthetic_episode)

torch.set_num_threads(2)


@pytest.fixture
def fresh(monkeypatch):
    """An empty cache for the test, the process's own restored after."""
    monkeypatch.setattr(tables, "_tables", collections.OrderedDict())


def _built(fn):
    """``fn()``'s result and the number of tables it built."""
    before = device_table.builds
    out = fn()
    return out, device_table.builds - before


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)


# ------------------------------------------- each site's table, bit-equal


def _rel_index_before(q_size, k_size):
    """The rel-pos index as ``rel_pos_table`` built it on every call."""
    q = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return torch.as_tensor(rel.astype(np.int64))


@pytest.mark.parametrize("q_size,k_size", [(14, 14), (64, 64), (7, 12)])
def test_rel_pos_table_gathers_the_index_it_built_before(fresh, q_size,
                                                         k_size):
    """SAM's window (14) and global (64) sizes, on ViT-B and ViT-H alike,
    and an uneven pair; the gather through the stored table stays per
    call, so a new ``rel_pos`` is read every time."""
    n = 2 * max(q_size, k_size) - 1
    rel_pos = torch.randn(n, 8)
    got, built = _built(lambda: rel_pos_table(rel_pos, q_size, k_size))
    assert built == 1
    assert torch.equal(got, rel_pos[_rel_index_before(q_size, k_size)])
    rel_pos2 = torch.randn(n, 8)
    got, built = _built(lambda: rel_pos_table(rel_pos2, q_size, k_size))
    assert built == 0
    assert torch.equal(got, rel_pos2[_rel_index_before(q_size, k_size)])


@pytest.mark.parametrize("in_size,out_size", [(672, 48), (48, 672),
                                              (256, 672), (1000, 7)])
def test_resize_nearest_takes_the_rows_it_built_before(fresh, in_size,
                                                       out_size):
    want = torch.as_tensor(np.clip(np.floor(
        np.arange(out_size, dtype=np.float32)
        * np.float32(in_size / out_size)).astype(np.int64), 0, in_size - 1))
    assert _same(resize._nearest_src(in_size, out_size, torch.device("cpu")),
                 want)
    x = torch.randn(2, in_size, in_size)
    assert torch.equal(resize.resize_nearest(x, (out_size, out_size)),
                       x[..., want, :][..., :, want])


def test_bilinear_then_nearest_weights_are_those_built_before(fresh):
    """The decode's post-resize: 256 -> 1024 -> 672."""
    lin = resize._linear_weights_np(256, 1024)
    near = np.clip(np.floor(np.arange(672, dtype=np.float32)
                            * np.float32(1024 / 672)).astype(np.int64),
                   0, 1023)
    want = torch.as_tensor(lin[near])
    got, built = _built(lambda: resize._bilinear_then_nearest_weights(
        256, 1024, 672, torch.device("cpu")))
    assert built == 1 and _same(got, want)
    x = torch.randn(2, 3, 256, 256)
    y = torch.einsum("...hw,jw->...hj", x, want)
    y = torch.einsum("...hj,ih->...ij", y, want)
    out, built = _built(lambda: resize.resize_bilinear_then_nearest(
        x, (1024, 1024), (672, 672)))
    assert built == 0 and torch.equal(out, y)


def test_preprocess_normalises_with_the_mean_and_std_built_before(fresh):
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    x = torch.rand(2, 3, 40, 30) * 255.0
    want = (x - torch.tensor(mean).reshape(1, 3, 1, 1)) \
        / torch.tensor(std).reshape(1, 3, 1, 1)
    got, built = _built(lambda: preprocess(x, 64))
    assert built == 1
    assert torch.equal(got[..., :40, :30], want)
    assert not got[..., 40:, :].any() and not got[..., 30:].any()
    # other statistics are another table
    _, built = _built(lambda: preprocess(x, 64, pixel_mean=(0.0, 0.0, 0.0)))
    assert built == 1


def test_prompt_encoder_scales_points_by_the_size_built_before(fresh):
    pe = PromptEncoder(embed_dim=32, image_embedding_size=(8, 8),
                       input_image_size=(96, 128))
    coords = torch.rand(3, 2, 2) * 96
    want = pe.pe_layer(coords / torch.tensor([128, 96], dtype=torch.float32))
    got, built = _built(lambda: pe._pe_points(coords))
    assert built == 1 and torch.equal(got, want)
    got, built = _built(lambda: pe.embed_boxes(coords.reshape(3, 4)))
    assert built == 0


# ------------------------------------------------------ the cache itself


def test_a_second_lookup_returns_the_same_tensor_without_a_build(fresh):
    calls = []

    def build():
        calls.append(1)
        return np.arange(5)

    first, built = _built(lambda: device_table(("t", 5), build, "cpu"))
    again, built2 = _built(lambda: device_table(("t", 5), build,
                                                torch.device("cpu")))
    assert (built, built2, len(calls)) == (1, 0, 1)
    assert again is first
    assert torch.equal(first, torch.arange(5))


def test_the_key_holds_the_device(fresh):
    cpu = device_table(("t",), lambda: np.arange(3), "cpu")
    meta, built = _built(lambda: device_table(("t",), lambda: np.arange(3),
                                              "meta"))
    assert built == 1
    assert (cpu.device.type, meta.device.type) == ("cpu", "meta")
    assert device_table(("t",), lambda: None, "cpu") is cpu


def test_the_least_recently_used_table_goes_past_the_bound(fresh,
                                                           monkeypatch):
    monkeypatch.setattr(tables, "CAPACITY", 3)
    a = device_table("a", lambda: np.zeros(1), "cpu")
    for k in "bc":
        device_table(k, lambda: np.zeros(1), "cpu")
    assert device_table("a", lambda: None, "cpu") is a  # a is now newest
    device_table("d", lambda: np.zeros(1), "cpu")       # b goes
    assert len(tables._tables) == 3
    _, built = _built(lambda: device_table("a", lambda: None, "cpu"))
    assert built == 0
    _, built = _built(lambda: device_table("b", lambda: np.zeros(1), "cpu"))
    assert built == 1


def test_tables_built_under_inference_mode_serve_autograd(fresh):
    with torch.inference_mode():
        rel_pos_table(torch.randn(27, 4), 14, 14)
    rel_pos = torch.randn(27, 4, requires_grad=True)
    rel_pos_table(rel_pos, 14, 14).sum().backward()
    assert rel_pos.grad is not None and rel_pos.grad.sum() == 14 * 14 * 4


def test_threads_share_the_cache_under_eviction(fresh, monkeypatch):
    """More threads than cores looking up more keys than the bound holds:
    every lookup gives its own key's table, and the cache never holds
    more than the bound."""
    monkeypatch.setattr(tables, "CAPACITY", 4)
    errors, sizes = [], []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(300):
                k = int(rng.integers(9))
                t = device_table(("k", k), lambda: np.full(3, k), "cpu")
                if not torch.equal(t, torch.full((3,), k)):
                    errors.append(k)
                with tables._lock:  # between two lookups
                    sizes.append(len(tables._tables))
        except Exception as e:  # noqa: BLE001  reported by the assert
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(sizes) == 16 * 300
    assert max(sizes) <= 4


# --------------------------------------------------- forward_volume, whole


def _tiny_pipeline(device):
    return build_pipeline(device, sam_ver="vit_t", coarse="dinov2_t14",
                          image_size=126, sam_size=256, dtype=torch.float32,
                          seed=3, config=ProtoSAMConfig(image_size=(256, 256),
                                                        max_ccs=4))


def _volume_tables() -> int:
    return next(s for s in reversed(profiling.spans())
                if s.name == "pipeline.volume").attrs["tables"]


def test_forward_volume_is_bit_equal_with_the_cache_cold_warm_and_off(
        fresh, monkeypatch):
    pipe = _tiny_pipeline("cpu")
    vol, inp = smooth_volume(3, 126, seed=4), synthetic_episode(126, "cpu", 5)
    cold = pipe.forward_volume(vol, inp, slice_batch=2)
    assert _volume_tables() > 0
    warm = pipe.forward_volume(vol, inp, slice_batch=2)
    assert _volume_tables() == 0
    # no table kept: every lookup builds anew, as every call did before
    monkeypatch.setattr(tables, "CAPACITY", 0)
    tables._tables.clear()
    off = pipe.forward_volume(vol, inp, slice_batch=2)
    assert _volume_tables() > 0
    for a, b, c in zip(cold, warm, off):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["tiny", "vit_b", "vit_h"])
def test_warm_forward_volume_makes_no_stream_sync(size):
    """After one call of the same shapes, ``forward_volume`` on the card
    runs from its first launch to its return with no stream sync, builds
    no table and gives the warm call's outputs bit for bit.  ``vit_b`` is
    the flagship (DINOv2-L/14 at 672, SAM ViT-B at 1024, bf16), ``vit_h``
    the SAM-H configuration with the fused routes (K5-K7)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: set_sync_debug_mode watches CUDA "
                    "streams")
    dev = torch.device("cuda")
    if size == "tiny":
        pipe, hw, n, sb = _tiny_pipeline(dev), 126, 3, 2
    else:
        kw = {"sam_ver": size}
        if size == "vit_h":
            kw.update(use_fused_alp=True, fused_mlp=True, fused_proj=True)
        pipe, hw, n, sb = build_pipeline(dev, **kw), 672, 6, 4
    vol = smooth_volume(n, hw, seed=4).to(dev)
    inp = synthetic_episode(hw, dev, 5)
    want = pipe.forward_volume(vol, inp, slice_batch=sb)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pipe.forward_volume(vol, inp, slice_batch=sb)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _volume_tables() == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
