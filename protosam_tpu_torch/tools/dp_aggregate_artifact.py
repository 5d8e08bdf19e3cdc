"""The data-parallel aggregate on the card, backed by executed runs: the
counterpart of ``tools/dp_aggregate_artifact.py``.

JAX compiled its dp program at the full geometry and counted collectives
in the HLO, executed it at a tiny geometry for bit-equality, and combined
a bench's single-chip slices/s into an aggregate.  Here every part runs:

1. the dp program at the full geometry (DINOv2-L/14 672 + SAM ViT-B, bf16,
   ``--slices`` slices over ``--ranks`` ranks): no collective before the
   final gather, masks bit-equal to ``forward_volume``'s at the same
   per-rank batch (``measure_dp_scaling``);
2. the same at the tiny f32 geometry;
3. the dp run's own slices/s (measured), and beside it a computed
   aggregate: R x the single-rank slices/s of part 1 over (1 + the
   overhead), the overhead as measured, negative or not.

The backend is NCCL unless ``--backend`` says otherwise; with fewer cards
than ranks pass ``--backend gloo`` and the ranks share the cards.  Raises
without a card.

    python3 -m protosam_tpu_torch.tools.dp_aggregate_artifact
        [--ranks 2] [--slices 8] [--backend nccl|gloo]
        [--out runs/dp_aggregate.json]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from protosam_tpu_torch.tools import measure_dp_scaling
from protosam_tpu_torch.tools.timing import card, log, require_cuda


def run(ranks: int = 2, n_slices: int = 8, reps: int = 2,
        backend: str | None = None) -> dict:
    require_cuda()
    full = measure_dp_scaling.run("flagship", ranks, n_slices, reps, backend)
    tiny = measure_dp_scaling.run("tiny", ranks, n_slices, reps, backend)
    for part in (full, tiny):
        if part["collectives_before_gather"] or not part[
                "dp_bit_equal_to_forward_volume"]:
            raise AssertionError(f"the dp program of {part['config']} "
                                 f"communicates before its gather or "
                                 f"differs from forward_volume: {part}")
    single_sps = n_slices / full["t_single_rank_ms"] * 1e3
    dp_sps = n_slices / full["t_dp_same_work_ms"] * 1e3
    eff = 1.0 / (1.0 + full["dp_program_overhead"])
    cards = torch.cuda.device_count()
    out = {"ranks": ranks, "cards": cards, "backend": full["backend"],
           "slices": n_slices, "full_geometry": full, "tiny_geometry": tiny,
           "measured": {"single_rank_slices_per_sec": single_sps,
                        "dp_slices_per_sec": dp_sps,
                        "dp_program_overhead": full["dp_program_overhead"],
                        "ranks_shared_cards": cards < ranks},
           "computed": {"efficiency": eff,
                        "aggregate_slices_per_sec": ranks * single_sps * eff,
                        "formula": "ranks * single_rank_slices_per_sec / "
                                   "(1 + dp_program_overhead)"},
           "card": card()}
    log(f"dp_aggregate_artifact: measured single rank {single_sps:.2f} "
        f"slices/s, dp over {ranks} ranks on {cards} card(s) {dp_sps:.2f} "
        f"slices/s (overhead {full['dp_program_overhead']:+.4f}); computed "
        f"aggregate {ranks} x {single_sps:.2f} / (1 + overhead) = "
        f"{out['computed']['aggregate_slices_per_sec']:.2f} slices/s")
    return out


def main(argv: list[str] | None = None) -> dict:
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--slices", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--backend", choices=("nccl", "gloo"))
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    out = run(a.ranks, a.slices, a.reps, a.backend)
    print(json.dumps(out), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
