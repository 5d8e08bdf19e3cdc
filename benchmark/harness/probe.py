"""The benchmark's spans around the program's stage entry points.

``Probe(pipe)`` replaces, on that one pipeline instance, the entry points
of each layer with wrappers that call them unchanged and

* with ``timing``, record a CUDA event on the current stream before and
  after the call (no synchronize: the elapsed device time is read once the
  window has closed);
* with ``annotate``, open a ``torch.profiler.record_function`` range named
  ``bench.<layer>/<entry>[b=<batch>]``, so the device trace can attribute
  each kernel to the layer and batch that launched it;
* while ``capture`` is a dict, keep what the entry returned (or, for
  ``forward_volume``, also its inputs), for the correctness check.

The layers, entry by entry (the program's module names):

* coarse: ``FewShotSeg.get_features`` (DINOv2, support encodes included)
  and ``FewShotSeg.score`` (ALP);
* prompts: ``ProtoSAM._extract_prompts`` (upsample, K3, points, boxes);
* sam_encoder: ``Sam.encode_image``;
* decode: ``ProtoSAM._decode_stage`` (prompt encoder, two-way
  transformer, mask head, post-resize);
* eval: ``ProtoSAM.forward_volume`` as ``run_eval`` calls it, ended by a
  synchronize, as the call's own copy of the masks to the host would end
  it.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


def _batch(args) -> int:
    for a in args:
        if isinstance(a, torch.Tensor):
            return int(a.shape[0])
    return 0


class Probe:
    def __init__(self, pipe, timing: bool = False, annotate: bool = False,
                 eval_span: bool = False):
        self.timing, self.annotate = timing, annotate
        self.events = collections.defaultdict(list)
        self.host_spans: list[tuple[float, float]] = []
        self.capture: dict | None = None
        coarse, sam = pipe.coarse_model, pipe.sam_model
        self._wrap(coarse, "get_features", "coarse", keep=True)
        self._wrap(coarse, "score", "coarse", keep=True)
        self._wrap(pipe, "_extract_prompts", "prompts", keep=True)
        self._wrap(sam, "encode_image", "sam_encoder", keep=True)
        self._wrap(sam, "decode", None, keep=True)
        self._wrap(pipe, "_decode_stage", "decode")
        if eval_span:
            self._wrap_volume(pipe)

    def _range(self, layer: str, name: str, b: int):
        if not self.annotate:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{layer}/{name}[b={b}]")

    def _wrap(self, obj, name: str, layer: str | None, keep: bool = False):
        orig = getattr(obj, name)

        def wrapped(*args, **kwargs):
            timed = self.timing and layer is not None
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            with self._range(layer or "decode", name, _batch(args)):
                out = orig(*args, **kwargs)
            if timed:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.events[layer].append((start, end))
            if keep and self.capture is not None:
                self.capture.setdefault(name, []).append(out)
            return out

        setattr(obj, name, wrapped)

    def _wrap_volume(self, pipe):
        orig = pipe.forward_volume

        def wrapped(queries, inp, slice_batch=8):
            t0 = time.perf_counter()
            with self._range("eval", "forward_volume", queries.shape[0]):
                out = orig(queries, inp, slice_batch=slice_batch)
                if queries.is_cuda:
                    torch.cuda.synchronize()
            self.host_spans.append((t0, time.perf_counter()))
            if self.capture is not None:
                self.capture.setdefault("forward_volume", []).append(
                    {"queries": queries, "support": inp.supp_imgs,
                     "support_mask": inp.fore_mask, "preds": out[0],
                     "scores": out[1]})
            return out

        pipe.forward_volume = wrapped

    def layer_ms(self) -> dict[str, float]:
        """Summed device milliseconds per layer (synchronizes)."""
        torch.cuda.synchronize()
        return {layer: sum(s.elapsed_time(e) for s, e in pairs)
                for layer, pairs in self.events.items()}
