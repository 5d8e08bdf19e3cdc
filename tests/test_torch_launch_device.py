"""Every kernel wrapper launches on the device of its tensors, whatever the
current device is.

On the CPU the tensors are ``OnCard``: CPU tensors that report ``cuda:1``
as their device, so each wrapper takes its kernel route.  The kernel
library, ``torch.cuda.device`` and ``torch.cuda.current_stream`` are
replaced by recorders: each C entry must be called inside
``torch.cuda.device(cuda:1)`` with that device's current stream as its last
argument.  The ``cuda`` test runs the kernels on a second card while the
first is current, and skips with fewer than two.
"""

import contextlib

import pytest
import torch

from protosam_tpu_torch import kernels
from protosam_tpu_torch.entry import set_f32_precision
from protosam_tpu_torch.ops import (alp, attention, cca, mlp, norm, quant,
                                   vitdet_flash)

CARD = torch.device("cuda", 1)
STREAM = 7321  # the fake current stream of CARD


class OnCard(torch.Tensor):
    """A CPU tensor whose ``device`` says CARD."""

    @property
    def device(self):
        return CARD


def _inputs(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return lambda *s: torch.randn(*s, generator=g).to(dtype)


def _k1(on):
    r = _inputs()
    return norm.layer_norm_rows(on(r(8, 16)), on(r(16)), on(r(16)))


def _k2(on):
    r = _inputs(torch.bfloat16)
    return attention.masked_flash_attention_packed(on(r(1, 8, 48)),
                                                   scale=0.25, num_heads=2,
                                                   n_valid=6)


def _k3(on):
    return cca.label_components(on(torch.ones(1, 8, 8, dtype=torch.uint8)))


def _k4(on):
    r = _inputs(torch.bfloat16)
    return vitdet_flash.relpos_patch_attention(on(r(1, 4, 4, 48)),
                                               on(r(1, 4, 4, 16)), 4, 2, 0.25)


def _k5(on):
    r = _inputs()
    return alp.alp_match_fused(on(r(1, 8, 2, 2)), on(r(3, 8)),
                               on(torch.ones(3, dtype=torch.bool)))


def _k6(on):
    r = _inputs(torch.bfloat16)
    return mlp.dense_residual(on(r(4, 16)), on(r(16, 16)), on(r(16)),
                              on(r(4, 16)))


def _k7(on):
    r = _inputs(torch.bfloat16)
    return mlp.mlp_fused(on(r(4, 16)), on(r(32, 16)), on(r(32)),
                         on(r(16, 32)), on(r(16)), on(r(4, 16)))


def _k8(on):
    return quant.quantize_rows(on(_inputs(torch.bfloat16)(8, 32)))[0]


def _k9(on):
    codes = torch.ones(4, 32, dtype=torch.int8)
    r = _inputs()
    return quant.int8_matmul_dequant(on(codes), on(codes[:3]), on(r(4)),
                                     on(r(3)), on(r(3)), torch.bfloat16)


WRAPPERS = {"K1": (_k1, "ptk_layer_norm_rows"),
            "K2": (_k2, "ptk_packed_masked_attention"),
            "K3": (_k3, "ptk_cca_label"),
            "K4": (_k4, "ptk_relpos_patch_attention"),
            "K5": (_k5, "ptk_alp_match"),
            "K6": (_k6, "ptk_dense_residual"),
            "K7": (_k7, "ptk_mlp_fused"),
            "K8": (_k8, "ptk_quantize_rows"),
            "K9": (_k9, "ptk_int8_dense")}


@pytest.fixture
def recorder(monkeypatch):
    """The kernel library, ``torch.cuda.device``, ``current_stream`` and
    ``torch.empty`` replaced by recorders.  Returns (calls, streams, args):
    each C entry call as (name, devices entered, stream), each stream
    asked for, and each call's arguments."""
    entered, calls, streams, args = [], [], [], []

    @contextlib.contextmanager
    def device(dev):
        entered.append(torch.device(dev))
        yield
        entered.pop()

    class Lib:
        def __getattr__(self, name):
            def call(*a):
                calls.append((name, list(entered), a[-1]))
                args.append(a)
                return 0
            return call

    class Stream:
        def __init__(self, dev):
            streams.append(torch.device(dev))
            self.cuda_stream = STREAM

    real_empty = torch.empty

    def empty(*size, device=None, **kw):
        t = real_empty(*size, **kw)
        return t.as_subclass(OnCard) if device == CARD else t

    monkeypatch.setattr(kernels, "library", Lib)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch, "empty", empty)
    return calls, streams, args


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_wrapper_launches_on_its_tensors_device(kernel, recorder):
    run, entry = WRAPPERS[kernel]
    calls, streams, _ = recorder
    run(lambda t: t.as_subclass(OnCard))
    assert calls == [(entry, [CARD], STREAM)]
    assert streams == [CARD]


def _k7_args(residual=True):
    r = _inputs(torch.bfloat16)
    return dict(x=r(4, 16), w1=r(32, 16), b1=r(32), w2=r(16, 32), b2=r(16),
                residual=r(4, 16) if residual else None)


def _on_card(args):
    return {k: None if v is None else v.as_subclass(OnCard)
            for k, v in args.items()}


def _misaligned(t):
    """``t``'s values one element past a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


def _strided(t):
    """``t``'s values every other column of a wider tensor."""
    wide = torch.zeros(t.shape[0], 2 * t.shape[1], dtype=t.dtype)
    wide[:, ::2] = t
    return wide[:, ::2]


@pytest.mark.parametrize("defect", ["non-contiguous", "misaligned"])
@pytest.mark.parametrize("name", ["x", "w1", "w2"])
def test_mlp_fused_refuses_what_tma_cannot_read(name, defect, recorder):
    """K7 reads x, W1 and W2 by TMA: the wrapper raises on a strided or a
    misaligned one before anything launches."""
    calls, _, _ = recorder
    args = _k7_args()
    bad = {"non-contiguous": _strided, "misaligned": _misaligned}[defect]
    args[name] = bad(args[name])
    assert torch.equal(args[name].float(), _k7_args()[name].float())
    with pytest.raises(ValueError,
                       match="not contiguous|not 16-byte aligned"):
        mlp.mlp_fused(**_on_card(args))
    assert calls == []


def test_mlp_fused_without_residual_launches_on_its_tensors_device(
        recorder):
    calls, streams, args = recorder
    a = _on_card(_k7_args(residual=False))
    out = mlp.mlp_fused(**a)
    assert calls == [("ptk_mlp_fused", [CARD], STREAM)]
    assert streams == [CARD]
    x, w1, b1, w2, b2, res, dst, m, c, h = args[0][:-1]
    assert res is None
    assert (x, w1, w2, dst) == (a["x"].data_ptr(), a["w1"].data_ptr(),
                                a["w2"].data_ptr(), out.data_ptr())
    assert (m, c, h) == (4, 16, 32)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs: the launch must follow the "
                    "tensors to the second")
    set_f32_precision()
    return torch.device("cuda", 1)


@pytest.mark.cuda
def test_kernels_run_on_the_second_card(two_cards):
    """With card 0 current, each wrapper on card 1 tensors gives what the
    same wrapper gives on card 0."""
    assert torch.cuda.current_device() == 0
    for kernel, (run, _) in WRAPPERS.items():
        on = lambda dev: lambda t: t.to(dev)
        want = run(on(torch.device("cuda", 0)))
        got = run(on(two_cards))
        assert got.device == two_cards, kernel
        torch.testing.assert_close(got.cpu(), want.cpu(), atol=0, rtol=0,
                                   msg=kernel)
