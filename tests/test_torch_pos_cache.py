"""DINOv2's resized position encoding, kept per encoder
(``DinoVisionTransformer._pos_encoding``): bit-equal to the encoding
resized on every call, one entry per grid, built anew after every way the
weight can change, bypassed where autograd tracks ``pos_embed``, and
absent from the state_dict.  ``pos_builds`` on each ``dinov2.encode`` span
reads 1 where the call resized it and 0 where the cache served it.  The
``cuda`` test runs a warm flagship ``forward_volume`` under
``torch.profiler``: no bicubic kernel runs on the card."""

import copy

import pytest
import torch

from protosam_tpu_torch.entry import build_pipeline
from protosam_tpu_torch.models.dinov2 import vit
from protosam_tpu_torch.models.dinov2.vit import (DinoVisionTransformer,
                                                  build_dinov2)
from protosam_tpu_torch.models.layers import cast_compute
from protosam_tpu_torch.pipeline.protosam import ProtoSAMConfig
from protosam_tpu_torch.utils import profiling
from protosam_tpu_torch.utils.synthetic import (smooth_volume,
                                                synthetic_episode,
                                                synthetic_state_dict)

torch.set_num_threads(2)

SIZE = 126  # a 9² grid: the 37² pretrain pos_embed is resized
MODELS = ["dinov2_vitt14", "dinov2_vitgt14"]


def _encoder(name: str, seed: int = 0) -> DinoVisionTransformer:
    enc = build_dinov2(name).eval()
    enc.load_state_dict(synthetic_state_dict(enc, seed))
    return enc


def _images(size: int = SIZE, seed: int = 1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, 3, size, size, generator=g)


def _encode(enc, x) -> tuple[torch.Tensor, int]:
    """The patch tokens and the call's ``pos_builds``."""
    with torch.no_grad():
        out = enc(x)["x_norm_patchtokens"]
    span = next(s for s in reversed(profiling.spans())
                if s.name == "dinov2.encode")
    return out, span.attrs["pos_builds"]


def _uncached(enc, gh: int, gw: int) -> torch.Tensor:
    """What the forward added on every call before the cache."""
    dt = enc.compute_dtype or enc.patch_embed.proj.weight.dtype
    with torch.no_grad():
        return enc._interpolate_pos_encoding(gh, gw).to(dt)


def _resize_every_call(monkeypatch):
    """The forward as it was: the encoding resized on every call."""
    monkeypatch.setattr(
        DinoVisionTransformer, "_pos_encoding",
        lambda self, gh, gw, dt: (
            self._interpolate_pos_encoding(gh, gw).to(dt), 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", MODELS)
def test_warm_forward_is_served_from_the_cache_bit_for_bit(
        name, dtype, monkeypatch):
    enc = cast_compute(_encoder(name), dtype)
    x = _images()
    before = DinoVisionTransformer.pos_builds
    cold, cold_builds = _encode(enc, x)
    warm, warm_builds = _encode(enc, x)
    assert (cold_builds, warm_builds) == (1, 0)
    assert DinoVisionTransformer.pos_builds == before + 1
    (_, _, pos), = enc._pos_cache.values()
    want = _uncached(enc, 9, 9)
    assert pos.dtype == want.dtype == dtype and torch.equal(pos, want)
    _resize_every_call(monkeypatch)
    off, _ = _encode(enc, x)
    assert torch.equal(cold, warm) and torch.equal(cold, off)


@pytest.mark.parametrize("name", MODELS)
def test_each_grid_keeps_its_own_entry(name):
    enc = _encoder(name)
    small, large = _images(98), _images(SIZE)
    assert [_encode(enc, x)[1] for x in (small, large, small, large)] == [
        1, 1, 0, 0]
    assert sorted(k[:2] for k in enc._pos_cache) == [(7, 7), (9, 9)]
    for (gh, gw, _, _), (_, _, pos) in enc._pos_cache.items():
        assert torch.equal(pos, _uncached(enc, gh, gw))


def test_the_cache_keeps_the_most_recent_grids(monkeypatch):
    monkeypatch.setattr(vit, "POS_CACHE_SIZE", 2)
    enc = _encoder("dinov2_vitt14")
    sizes = [70, 98, SIZE, 70]
    assert [_encode(enc, _images(s))[1] for s in sizes] == [1, 1, 1, 1]
    assert [k[:2] for k in enc._pos_cache] == [(9, 9), (5, 5)]


def _load_other(enc):
    enc.load_state_dict(synthetic_state_dict(enc, 7))
    return enc, _encoder("dinov2_vitt14", 7)


def _cast_bf16(enc):
    return cast_compute(enc, torch.bfloat16), cast_compute(
        _encoder("dinov2_vitt14"), torch.bfloat16)


def _master_bf16(enc):
    return (cast_compute(enc, torch.bfloat16, master_weights=True),
            cast_compute(_encoder("dinov2_vitt14"), torch.bfloat16,
                         master_weights=True))


def _deepcopy_then_load(enc):
    """A copy's cache serves the copy's weights, not the original's."""
    dup = copy.deepcopy(enc)
    dup.load_state_dict(synthetic_state_dict(dup, 7))
    return dup, _encoder("dinov2_vitt14", 7)


def _deepcopy_then_step_the_original(enc):
    dup = copy.deepcopy(enc)
    with torch.no_grad():
        enc.pos_embed.mul_(3.0)
    return dup, _encoder("dinov2_vitt14")


def _step_in_place(enc):
    fresh = _encoder("dinov2_vitt14")
    with torch.no_grad():
        for m in (enc, fresh):
            m.pos_embed.add_(0.5)
    return enc, fresh


def _swap_data(enc):
    """``.data =`` moves the pointer and not ``_version``."""
    fresh, other = _encoder("dinov2_vitt14"), _encoder("dinov2_vitt14", 7)
    enc.pos_embed.data = other.pos_embed.data.clone()
    fresh.pos_embed.data = other.pos_embed.data
    return enc, fresh


def _swap_parameter(enc):
    fresh = _encoder("dinov2_vitt14", 7)
    enc.load_state_dict(fresh.state_dict(), assign=True)
    return enc, fresh


def _load_in_inference_mode(enc):
    """Weights that are inference tensors, loaded in place under
    ``inference_mode``, which moves no ``_version``."""
    with torch.inference_mode():
        for prm in enc.parameters():
            prm.data = prm.data.clone()
    assert _encode(enc, _images())[1] == 1
    with torch.inference_mode():
        enc.load_state_dict(synthetic_state_dict(enc, 7))
    return enc, _encoder("dinov2_vitt14", 7)


@pytest.mark.parametrize("change", [
    _load_other, _cast_bf16, _master_bf16, _deepcopy_then_load,
    _deepcopy_then_step_the_original, _step_in_place, _swap_data,
    _swap_parameter, _load_in_inference_mode])
def test_a_changed_weight_is_never_served_a_stale_entry(change):
    enc, x = _encoder("dinov2_vitt14"), _images()
    _encode(enc, x)
    assert _encode(enc, x)[1] == 0
    changed, fresh = change(enc)
    got, builds = _encode(changed, x)
    want, _ = _encode(fresh, x)
    assert builds == 1 and torch.equal(got, want)


@pytest.mark.parametrize("name", MODELS)
def test_a_trainable_pos_embed_gets_the_gradient_it_got_before(
        name, monkeypatch):
    x = _images()

    def grads(enc):
        enc.zero_grad()
        enc(x)["x_norm_patchtokens"].square().mean().backward()
        return {n: p.grad.clone() for n, p in enc.named_parameters()
                if p.grad is not None}

    enc = _encoder(name).train()
    _encode(enc, x)  # an entry is there; training must not take it
    got = grads(enc)
    assert next(s for s in reversed(profiling.spans())
                if s.name == "dinov2.encode").attrs["pos_builds"] == 1
    _resize_every_call(monkeypatch)
    want = grads(enc)
    assert got.keys() == want.keys() and "pos_embed" in got
    assert got["pos_embed"].abs().max() > 0
    for n in want:
        assert torch.equal(got[n], want[n]), n


def test_an_entry_built_under_inference_mode_serves_a_frozen_grad_call():
    enc, x = _encoder("dinov2_vitt14"), _images()
    with torch.inference_mode():
        first = enc(x)["x_norm_patchtokens"].clone()
    (_, _, pos), = enc._pos_cache.values()
    assert not pos.is_inference()
    enc.requires_grad_(False)
    xg = x.clone().requires_grad_()
    out = enc(xg)["x_norm_patchtokens"]
    assert next(s for s in reversed(profiling.spans())
                if s.name == "dinov2.encode").attrs["pos_builds"] == 0
    out.square().mean().backward()
    assert xg.grad is not None and xg.grad.abs().max() > 0
    assert torch.equal(out.detach(), first)


@pytest.mark.parametrize("name", MODELS)
def test_the_cache_is_not_in_the_state_dict(name):
    enc, fresh = _encoder(name), _encoder(name)
    _encode(enc, _images())
    assert enc._pos_cache
    assert list(enc.state_dict()) == list(fresh.state_dict())
    assert list(enc.named_buffers()) == []
    # and a strict load into a warm encoder still takes every key
    enc.load_state_dict(fresh.state_dict(), strict=True)


def _tiny_pipeline(device):
    return build_pipeline(device, sam_ver="vit_t", coarse="dinov2_t14",
                          image_size=126, sam_size=256, dtype=torch.float32,
                          seed=3, config=ProtoSAMConfig(image_size=(256, 256),
                                                        max_ccs=4))


def _volume_pos_builds() -> list[int]:
    """``pos_builds`` of each ``dinov2.encode`` span under the last
    ``pipeline.volume``."""
    vol = next(s for s in reversed(profiling.spans())
               if s.name == "pipeline.volume")
    return [s.attrs["pos_builds"] for s in profiling.spans(within=vol)
            if s.name == "dinov2.encode"]


def test_warm_forward_volume_builds_no_pos_encoding(monkeypatch):
    pipe = _tiny_pipeline("cpu")
    vol, inp = smooth_volume(3, 126, seed=4), synthetic_episode(126, "cpu", 5)
    cold = pipe.forward_volume(vol, inp, slice_batch=2)
    assert sum(_volume_pos_builds()) == 1
    warm = pipe.forward_volume(vol, inp, slice_batch=2)
    builds = _volume_pos_builds()
    assert len(builds) == 3 and builds == [0, 0, 0]  # support + 2 batches
    _resize_every_call(monkeypatch)
    off = pipe.forward_volume(vol, inp, slice_batch=2)
    for a, b, c in zip(cold, warm, off):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_warm_flagship_forward_volume_runs_no_bicubic_kernel():
    """The flagship (DINOv2-L/14 at 672, SAM ViT-B at 1024, bf16): after
    one call of the same shapes, a ``forward_volume`` under
    ``torch.profiler`` runs no ``upsample_bicubic`` kernel on the card, and
    each of its ``dinov2.encode`` spans reads ``pos_builds`` 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the profiler lists the card's "
                    "kernels")
    dev = torch.device("cuda")
    pipe = build_pipeline(dev)
    vol = smooth_volume(6, 672, seed=4).to(dev)
    inp = synthetic_episode(672, dev, 5)
    want = pipe.forward_volume(vol, inp, slice_batch=4)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = pipe.forward_volume(vol, inp, slice_batch=4)
        torch.cuda.synchronize()
    builds = _volume_pos_builds()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels, "the profiler recorded no kernel on the card"
    assert not [k for k in kernels if "upsample_bicubic" in k]
    assert len(builds) == 3 and builds == [0, 0, 0]  # support + 2 batches
    assert all(torch.equal(a, b) for a, b in zip(got, want))
