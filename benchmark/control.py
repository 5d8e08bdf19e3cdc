"""Readings of the program and of the control for setting the limits of a
cell's compared numbers, on the card, several seeds in one process.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3
        --seconds <s> [--variants lowref int8]

``lowref`` is the cell as the benchmark runs it (its ``readings``), with
the control of the float32 stages' numbers beside them (``lowref``): the
reference computed a precision lower (bfloat16; float32 for the float64
scores) put in the program's place for the prompts, the decoder and
post-resize, the data layer and the scores.  ``int8`` is the control of
the encoders' numbers: the program's own int8 path (``quant_dense``: W8A8
dense layers in both encoders), the precision below the configuration's
bfloat16.  Each run prints one JSON line.  The benchmark's own runs never
run a control.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--variants", nargs="+", default=["lowref", "int8"])
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for variant in args.variants:
            t0 = time.perf_counter()
            res, _, earlier = cell.run(
                args.workload, seed, args.seconds, False, t0,
                variant=variant, root=ROOT)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": variant,
                              "readings": {k: v["value"] for k, v in
                                           res["checks"].items()},
                              "lowref": res.get("lowref"),
                              "correct": res["correct"],
                              "metrics": res["metrics"],
                              "run": earlier}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
