"""Driver ``eval``: whole ``eval.protosam_eval.run_eval`` calls back to
back (closed loop, one researcher), on a fold that set-up writes under
``TMPDIR``; each call loads the fold, segments and scores it, as a user's
run of the evaluation does."""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import checks, synth
from benchmark.harness.traffic import sync


class Driver:
    # run_eval calls the traced tail runs after the window
    trace_calls = 1

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from protosam_tpu_torch.utils.config import load_config

        self.cfg, self.mix, self.device = cfg, mix, device
        fold = mix["fold"]
        self.dir = tempfile.mkdtemp(prefix="bench_fold_")
        self.fold_dir = os.path.join(self.dir, "fold")
        self.written = synth.write_fold(self.fold_dir, fold["scan_ids"],
                                        fold["depth"], fold["side"], seed)
        prog = cfg["program"]
        size = mix["input_size"]
        argv = ["with", f"modelname={prog['modelname']}",
                "base_model=alpnet", "coarse_pred_only=False",
                f"protosam_sam_ver={prog['protosam_sam_ver']}",
                f"curr_cls={mix['organ']}", f"eval_fold={mix['eval_fold']}",
                f"dataset={mix['dataset']}",
                f"proto_grid_size={cfg['coarse']['proto_grid']}",
                f"seed={seed}", "do_cca=True",
                f"skip_no_organ_slices={mix['skip_no_organ_slices']}",
                "lora=0", f"support_idx={mix['support_idx']}",
                f"n_sup_part={mix['n_sup_part']}",
                f"input_size=({size}, {size})",
                f"path.{mix['data_key']}.data_dir={self.fold_dir}",
                f"dtype={cfg['pipeline']['dtype']}",
                f"slice_batch={mix['slice_batch']}"]
        self.pcfg = load_config(argv)
        self.pcfg.log_dir = ""
        # the check takes one of the mix's first ``check_among`` calls,
        # drawn from the seed
        rng = np.random.default_rng([seed % (1 << 63), 2])
        self.check_calls = [int(rng.integers(0, mix["check_among"]))]
        self.stats = {"calls": 0, "slices": 0}
        self.call_s: list[float] = []

    def _call(self, pipe):
        from protosam_tpu_torch.eval.protosam_eval import run_eval

        return run_eval(self.pcfg, pipe=pipe, mode="volume")

    def warm(self, pipe):
        self._call(pipe)
        sync(self.device)

    def window(self, pipe, probe, seconds: float, check: bool) -> dict:
        captured, walls = [], []
        probe.host_spans.clear()
        t0 = time.perf_counter()
        call = 0
        while time.perf_counter() - t0 < seconds:
            take = check and call in self.check_calls
            probe.capture = {} if take else None
            c0 = time.perf_counter()
            res = self._call(pipe)
            walls.append((c0, time.perf_counter()))
            if take:
                captured.append({"capture": probe.capture, "result": res})
            probe.capture = None
            self.stats["calls"] += 1
            self.stats["slices"] += res["n_slices"]
            call += 1
        sync(self.device)
        self.call_s = [b - a for a, b in walls]
        return {"wall_s": sum(b - a for a, b in walls), "captured": captured,
                "call_spans": walls}

    def extra(self, pipe, calls: int):
        for _ in range(calls):
            self._call(pipe)

    def summary(self) -> dict:
        s = dict(self.stats)
        s["call_s"] = self.call_s
        s["fold_bytes"] = self.written["bytes"]
        s["fold_raw_bytes"] = self.written["raw_bytes"]
        return s

    def release(self):
        pass

    def readings(self, ref, out: dict, lower: bool = False) -> dict:
        worst: dict[str, float] = {}
        for c in out["captured"]:
            r = checks.eval_readings(ref, self.mix, self.fold_dir,
                                     c["capture"], c["result"],
                                     lower=lower)
            for k, v in r.items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    def close(self):
        shutil.rmtree(self.dir, ignore_errors=True)
