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

    python3 -m protosam_tpu_torch.tools.bench_dino_flash [--reps 10]
"""

from __future__ import annotations

import argparse

import torch

from protosam_tpu_torch.ops.attention import (masked_attention_packed_plain,
                                              masked_flash_attention_packed)
from protosam_tpu_torch.tools.microbench_attn import (B, HD, N_VALID, NH, S,
                                                      SCALE, qkv_input, sdpa)
from protosam_tpu_torch.tools.roofline import kernel_cost
from protosam_tpu_torch.tools.timing import (bf16_error, device_ms, log,
                                             require_cuda)


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
    return out


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    return run(reps=ap.parse_args(argv).reps)


if __name__ == "__main__":
    main()
