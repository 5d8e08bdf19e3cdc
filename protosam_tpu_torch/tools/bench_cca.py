"""Connected-component labelling, kernel K3, on the card: the counterpart
of ``tools/bench_cca.py``.

K3 against its plain version on a stack of 1024² masks made with the JAX
tool's recipe (``bench_cca.py:21-47``): in turn anatomy-like smooth blobs
(a thresholded low-frequency field), a serpentine (one long component, the
worst case for label propagation) and speckle noise (many tiny
components).  The two must give equal labels; both are timed per mask.

    python3 -m protosam_tpu_torch.tools.bench_cca [--masks 8] [--reps 5]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from protosam_tpu_torch.ops.cca import label_components, label_components_plain
from protosam_tpu_torch.tools.roofline import kernel_cost
from protosam_tpu_torch.tools.timing import device_ms, log, require_cuda


def make_masks(k: int, side: int = 1024, seed: int = 0) -> np.ndarray:
    """(k, side, side) int32 masks, the JAX tool's three kinds in turn."""
    rng = np.random.default_rng(seed)
    masks = []
    for i in range(k):
        kind = i % 3
        if kind == 0:  # anatomy-like smooth blobs
            coarse = rng.standard_normal((16, 16))
            up = np.kron(coarse, np.ones((side // 16, side // 16)))
            for _ in range(2):
                up = (np.roll(up, 1, 0) + np.roll(up, -1, 0) +
                      np.roll(up, 1, 1) + np.roll(up, -1, 1) + up) / 5
            m = (up > np.quantile(up, 0.8)).astype(np.int32)
        elif kind == 1:  # serpentine
            m = np.zeros((side, side), np.int32)
            for r in range(8, side - 8, 16):
                m[r:r + 8, 8:side - 8] = 1
            for j, r in enumerate(range(8, side - 24, 16)):
                if j % 2 == 0:
                    m[r:r + 24, side - 16:side - 8] = 1
                else:
                    m[r:r + 24, 8:16] = 1
        else:  # speckle noise
            m = (rng.random((side, side)) > 0.7).astype(np.int32)
        masks.append(m)
    return np.stack(masks)


def run(n_masks: int = 8, reps: int = 5) -> dict:
    dev = require_cuda()
    masks = torch.from_numpy(make_masks(n_masks)).to(dev)
    got = label_components(masks)
    want = label_components_plain(masks)
    if not torch.equal(got, want):
        raise AssertionError("K3 labels differ from the plain version's")
    _, _, bound_ms, bound_by = kernel_cost("cca_label", b=n_masks, h=1024,
                                           w=1024)
    t = device_ms(lambda: label_components(masks), reps=reps)
    plain = device_ms(lambda: label_components_plain(masks), reps=1,
                      runs=3)
    log(f"K3 cca_label ({n_masks} x 1024^2: blobs, serpentine, speckle): "
        f"labels equal to the plain version's; kernel {t} = "
        f"{t.median_ms / n_masks:.4f} ms/mask; plain {plain} = "
        f"{plain.median_ms / n_masks:.3f} ms/mask; bound {bound_ms:.4f} ms "
        f"({bound_by})")
    return {"ms": t.median_ms, "plain_ms": plain.median_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--masks", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    return run(n_masks=args.masks, reps=args.reps)


if __name__ == "__main__":
    main()
