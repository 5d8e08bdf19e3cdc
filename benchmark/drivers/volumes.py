"""Driver ``volumes``: volumes back to back through
``ProtoSAM.forward_volume`` (closed loop, one client).  The depths are the
mix's ``depths``, the same set for every seed; the seed draws each volume's
slices and its support slice, and the order of every cycle through the
set.  The volumes are made in set-up and held on the card."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import checks, synth
from benchmark.harness.traffic import sync


class Driver:
    # volumes the traced tail runs after the window
    trace_calls = 2

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        size = cfg["coarse"]["input_size"]
        g = synth.generator(seed, device)
        self.pool = []
        for depth in mix["depths"]:
            q = synth.smooth_slices(depth, size, g, device)
            s_img, s_lbl = synth.support(size, g, device)
            self.pool.append((q, s_img, s_lbl))
        rng = np.random.default_rng([seed % (1 << 63), 1])
        self.rng = rng
        self.order: list[int] = []
        # the check takes the deepest volume's first call and one more of
        # the first cycle, drawn from the seed
        first = list(rng.permutation(len(self.pool)))
        self.order += first
        deepest = int(np.argmax(mix["depths"]))
        others = [i for i in range(len(first)) if first[i] != deepest]
        self.check_calls = sorted({first.index(deepest)}
                                  | {int(rng.choice(others))
                                     for _ in others[:1]})
        self.stats = {"calls": 0, "slices": 0, "padded": 0,
                      "depths": {}, "scores": []}

    def _index(self, call: int) -> int:
        while call >= len(self.order):
            self.order += list(self.rng.permutation(len(self.pool)))
        return self.order[call]

    def _call(self, pipe, i: int):
        from protosam_tpu_torch.models.io_protocol import ALPNetInput

        q, s_img, s_lbl = self.pool[i]
        inp = ALPNetInput(s_img, s_lbl, q[:1], isval=True, val_wsize=2)
        return pipe.forward_volume(q, inp,
                                   slice_batch=self.mix["slice_batch"])

    def warm(self, pipe):
        self._call(pipe, int(np.argmin(self.mix["depths"])))
        sync(self.device)

    def window(self, pipe, probe, seconds: float, check: bool) -> dict:
        sb = self.mix["slice_batch"]
        captured = []
        t0 = time.perf_counter()
        call = 0
        while time.perf_counter() - t0 < seconds:
            i = self._index(call)
            take = check and call in self.check_calls
            probe.capture = {} if take else None
            preds, scores = self._call(pipe, i)
            depth = self.pool[i][0].shape[0]
            if take:
                captured.append({"inputs": self.pool[i],
                                 "capture": probe.capture,
                                 "preds": preds, "scores": scores})
            probe.capture = None
            self.stats["scores"].append(scores)
            self.stats["calls"] += 1
            self.stats["slices"] += depth
            self.stats["padded"] += (-depth) % sb
            self.stats["depths"][depth] = self.stats["depths"].get(depth,
                                                                   0) + 1
            call += 1
        sync(self.device)
        wall = time.perf_counter() - t0
        self.next_call = call
        return {"wall_s": wall, "captured": captured}

    def extra(self, pipe, calls: int):
        """``calls`` more volumes, after the window (the traced tail)."""
        for k in range(calls):
            self._call(pipe, self._index(self.next_call + k))

    def summary(self) -> dict:
        scores = torch.cat(self.stats.pop("scores")) if self.stats.get(
            "scores") else torch.zeros(0)
        s = dict(self.stats)
        s["empty_coarse"] = int((scores == 0).all(dim=1).sum())
        s.pop("scores", None)
        return s

    def release(self):
        self.pool = []

    def close(self):
        pass

    def readings(self, ref, out: dict, lower: bool = False) -> dict:
        worst: dict[str, float] = {}
        for c in out["captured"]:
            q, s_img, s_lbl = c["inputs"]
            r = checks.volume_readings(ref, q, s_img, s_lbl, c["capture"],
                                       c["preds"], c["scores"],
                                        lower=lower)
            for k, v in r.items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst
