"""Library attention at the DINOv2-L shape on the card: the counterpart of
``tools/bench_dino_flash.py``.

The JAX tool sweeps the block sizes of JAX's stock TPU flash attention, a
library kernel, at DINOv2-L (batch 8, 16 heads × 64, 2305 real tokens).
The counterpart sweeps the backends of PyTorch's library attention,
``F.scaled_dot_product_attention`` under ``torch.nn.attention.sdpa_kernel``
(flash, memory-efficient, cuDNN, math), on head-split views of a packed
qkv (8, 2432, 3·1024) bf16 with k and v sliced to the 2305 real keys, and
times kernel K2 on the same qkv beside them.  A backend that refuses the
shape is reported as such.

On that input a kernel that let the keys past n_valid into the softmax
could still stay inside the bf16 bound.  ``check_mask`` holds K2 on
inputs from ``mask_check_inputs`` instead, where the keys and values at or
past n_valid are ``MASK_SCALE`` times larger than the valid ones: K2 must
stay within the bf16 bound of its f32 plain version, and the plain version
with n_valid = S, the control, must fail that bound, which shows the inputs
tell a masked softmax from an unmasked one.

    python3 -m protosam_tpu_torch.tools.bench_dino_flash [--reps 10]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from protosam_tpu_torch.ops.attention import (masked_attention_packed_plain,
                                              masked_flash_attention_packed)
from protosam_tpu_torch.tools.microbench_attn import (B, HD, N_VALID, NH, S,
                                                      SCALE, qkv_input, sdpa)
from protosam_tpu_torch.tools.roofline import kernel_cost
from protosam_tpu_torch.tools.timing import (bf16_error, device_ms, log,
                                             require_cuda)


MASK_SCALE = 8.0


def mask_check_inputs(b: int, s: int, nh: int, hd: int, n_valid: int,
                      seed: int = 0) -> np.ndarray:
    """qkv (b, s, 3·nh·hd) float32 for ``check_mask``: N(0, 1), with the k
    and v of every token at or past n_valid times ``MASK_SCALE``."""
    c = nh * hd
    qkv = np.random.default_rng(seed).standard_normal((b, s, 3 * c),
                                                      dtype=np.float32)
    qkv[:, n_valid:, c:] *= np.float32(MASK_SCALE)
    return qkv


def check_mask(qkv: torch.Tensor, *, scale: float, num_heads: int,
               n_valid: int) -> dict:
    """Hold K2 against its f32 plain version on ``qkv`` from
    ``mask_check_inputs`` (see the module docstring); raises where it
    fails, or where the unmasked control does not."""
    kw = dict(scale=scale, num_heads=num_heads)
    want = masked_attention_packed_plain(qkv.float(), n_valid=n_valid, **kw)
    control = masked_attention_packed_plain(qkv.float(), **kw)
    got = masked_flash_attention_packed(qkv, n_valid=n_valid, **kw)
    err, tol = bf16_error(got, want)
    control_err, _ = bf16_error(control, want)
    out = {"max_abs_err": err, "bound": tol, "control_max_err": control_err}
    if err > tol:
        raise AssertionError(f"K2 lets keys past n_valid in: {out}")
    if control_err <= tol:
        raise AssertionError(f"the unmasked control passes the bf16 bound: "
                             f"the inputs cannot tell: {out}")
    return out


def run(reps: int = 10) -> dict:
    from torch.nn.attention import SDPBackend, sdpa_kernel

    dev = require_cuda()
    qkv = torch.from_numpy(qkv_input()).to(device=dev, dtype=torch.bfloat16)
    kw = dict(scale=SCALE, num_heads=NH, n_valid=N_VALID)
    flops, _, bound_ms, bound_by = kernel_cost(
        "packed_masked_attention", b=B, s=S, nh=NH, hd=HD, n_valid=N_VALID)
    want = masked_attention_packed_plain(qkv, **kw)
    log(f"DINOv2-L attention ({B}, {S}, {3 * NH * HD}) bf16, n_valid "
        f"{N_VALID}: {flops / 1e9:.1f} GFLOP, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    out = {"bound_ms": bound_ms}
    backends = {"flash": SDPBackend.FLASH_ATTENTION,
                "efficient": SDPBackend.EFFICIENT_ATTENTION,
                "cudnn": SDPBackend.CUDNN_ATTENTION,
                "math": SDPBackend.MATH}
    for name, backend in backends.items():
        try:
            with sdpa_kernel([backend]):
                err, _ = bf16_error(sdpa(qkv, **kw), want)
                t = device_ms(lambda: sdpa(qkv, **kw), reps=reps)
        except RuntimeError as e:  # the backend refuses this shape or card
            out[name] = None
            log(f"SDPA {name}: not eligible ({str(e).splitlines()[0][:100]})")
            continue
        out[name] = t.median_ms
        log(f"SDPA {name}: {t} = {flops / t.median_ms / 1e9:.1f} TFLOP/s, "
            f"max_abs_err vs plain {err:.2e}")
    err, tol = bf16_error(masked_flash_attention_packed(qkv, **kw), want)
    if err > tol:
        raise AssertionError(f"K2: {err} > {tol}")
    t = device_ms(lambda: masked_flash_attention_packed(qkv, **kw),
                  reps=reps)
    out["K2"] = t.median_ms
    log(f"K2 packed_masked_attention: {t} = "
        f"{flops / t.median_ms / 1e9:.1f} TFLOP/s, max_abs_err vs plain "
        f"{err:.2e}")
    del qkv
    big = torch.from_numpy(mask_check_inputs(B, S, NH, HD, N_VALID)).to(
        device=dev, dtype=torch.bfloat16)
    out["mask_check"] = chk = check_mask(big, **kw)
    log(f"K2 check_mask (keys past n_valid x {MASK_SCALE:g}): max_abs_err "
        f"{chk['max_abs_err']:.2e} (bound {chk['bound']:.2e}); unmasked "
        f"control {chk['control_max_err']:.2e}")
    return out


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    return run(reps=ap.parse_args(argv).reps)


if __name__ == "__main__":
    main()
