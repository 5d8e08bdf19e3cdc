"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Earlier lines of standard output record the card (name, power limit,
clocks), the peak device memory, the set-up and window seconds and the
traffic (depths, padded slices, empty coarse masks, bytes written); the
last line is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics untraced, the per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit.  The compared numbers
are also the last lines of standard error.

Exits 2 without a result where no card (or fewer than the cell asks for)
is visible, and 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# fixed cache directories inside the checkout, so only a checkout's first
# run builds or compiles
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell

    work = next((w for w in cell.manifest(ROOT)["workloads"]
                 if w["name"] == args.workload), None)
    if work is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < work["chips"]:
        print(f"{args.workload} needs {work['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines, earlier = cell.run(args.workload, args.seed,
                                      args.seconds, bool(args.trace), T0,
                                      root=ROOT)
    found = cell.forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    for e in earlier:
        print(json.dumps(e), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
