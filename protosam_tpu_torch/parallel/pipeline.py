"""Two-stage pipeline parallelism over the slice stream (JAX
``parallel/pipeline.py``).

Stage A (the coarse model and the device-side prompt extraction) and stage
B (the SAM encoder and the batched decode) run on disjoint ranks, one
process a rank.  Each stage holds only its own weights: on a stage-A rank
SAM's parameters are dropped, on a stage-B rank the coarse model's, so a
pairing that does not fit one card still runs, at the cost of one
microbatch of bubble.  The prompt tensors go A -> B with ``isend`` /
``irecv`` while stage A computes the next microbatch.

When to use which (as in JAX): dp (``ProtoSAM.forward_volume_sharded``)
when both encoders fit one card, since the slices are independent and dp
communicates only its final gather; pp when they do not; tp
(``parallel.sharding``) splits single layers and composes with dp.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from protosam_tpu_torch.parallel.sharding import (_require_group, irecv,
                                                  isend)

# the prompt dict of ``ProtoSAM._extract_prompts``, in the order it is sent
_KEYS = ("sam_image", "coords", "labels", "boxes", "valid", "pred",
         "mask_inputs")
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32,
           torch.int64, torch.bool)
_MAX_DIMS = 6


def _drop_parameters(module: torch.nn.Module) -> None:
    """Free ``module``'s parameters (its buffers and attributes stay)."""
    for m in module.modules():
        for name in list(m._parameters):
            m._parameters[name] = None


def _header(ex: dict) -> torch.Tensor:
    """Per key: present, dtype index, ndim, dims (padded)."""
    rows = []
    for k in _KEYS:
        t = ex.get(k)
        if t is None:
            rows.append([0] * (3 + _MAX_DIMS))
        else:
            dims = list(t.shape) + [0] * (_MAX_DIMS - t.ndim)
            rows.append([1, _DTYPES.index(t.dtype), t.ndim] + dims)
    return torch.tensor(rows, dtype=torch.int64)


class PipelinedVolumeRunner:
    """Drives a ``ProtoSAM`` / ``ProtoMedSAM`` as a two-stage pipeline over
    slice microbatches.  ``stage_a_ranks`` / ``stage_b_ranks``: disjoint
    world ranks; within a stage the microbatch splits over its ranks (pp
    composes with dp).  Every rank of the group builds the runner; a rank
    in neither stage only joins the final gather.  The runner takes the
    pipeline over: on this rank the other stage's parameters are freed."""

    def __init__(self, pipe, stage_a_ranks, stage_b_ranks, *,
                 val_wsize: int = 2):
        _require_group()
        self.stage_a, self.stage_b = list(stage_a_ranks), list(stage_b_ranks)
        if set(self.stage_a) & set(self.stage_b):
            raise ValueError("pipeline stages must use disjoint ranks")
        self.pipe = pipe
        self.val_wsize = val_wsize
        self.rank = dist.get_rank()
        if self.rank in self.stage_a:
            _drop_parameters(pipe.sam_model)
        elif self.rank in self.stage_b:
            _drop_parameters(pipe.coarse_model)
        else:
            _drop_parameters(pipe.sam_model)
            _drop_parameters(pipe.coarse_model)

    @staticmethod
    def _rows(m: int, ranks: list, rank: int) -> range:
        k = m // len(ranks)
        i = ranks.index(rank)
        return range(i * k, (i + 1) * k)

    @torch.no_grad()
    def _stage_a(self, chunks, inp, m):
        pipe = self.pipe
        dev = next(pipe.coarse_model.parameters()).device
        mine = self._rows(m, self.stage_a, self.rank)
        supp_fts = inp.supp_fts
        if supp_fts is None:
            supp_fts = pipe.coarse_model.get_features(inp.supp_imgs)
        pending = []
        for chunk in chunks:
            q = chunk[mine.start:mine.stop].to(dev)
            logits = pipe.coarse_model(inp.supp_imgs, inp.fore_mask,
                                       inp.back_mask, q, True,
                                       self.val_wsize,
                                       supp_fts=supp_fts)["logits"]
            ex = pipe._extract_prompts(q, logits)
            # the last microbatch's sends complete while this one computed
            for work, _ in pending:
                work.wait()
            pending = []
            for b in self.stage_b:
                theirs = self._rows(m, self.stage_b, b)
                lo, hi = max(mine.start, theirs.start), min(mine.stop,
                                                            theirs.stop)
                if lo >= hi:
                    continue
                part = {k: (None if ex.get(k) is None
                            else ex[k][lo - mine.start:hi - mine.start])
                        for k in _KEYS}
                pending.append(isend(_header(part).to(dev), b))
                pending += [isend(part[k], b) for k in _KEYS
                            if part[k] is not None]
        for work, _ in pending:
            work.wait()

    @torch.no_grad()
    def _stage_b(self, n_chunks, hw, m):
        pipe = self.pipe
        dev = next(pipe.sam_model.parameters()).device
        mine = self._rows(m, self.stage_b, self.rank)
        preds, scores = [], []
        for _ in range(n_chunks):
            pieces = []
            for a in self.stage_a:
                theirs = self._rows(m, self.stage_a, a)
                if max(mine.start, theirs.start) >= min(mine.stop,
                                                        theirs.stop):
                    continue
                work, head = irecv((len(_KEYS), 3 + _MAX_DIMS),
                                   torch.int64, dev, a)
                work.wait()
                bufs = {}
                for k, row in zip(_KEYS, head.tolist()):
                    if row[0]:
                        bufs[k] = irecv(row[3:3 + row[2]], _DTYPES[row[1]],
                                        dev, a)
                part = {}
                for k in _KEYS:
                    if k in bufs:
                        work, buf = bufs[k]
                        work.wait()
                        part[k] = buf.to(dev)
                pieces.append(part)
            ex = {k: (torch.cat([p[k] for p in pieces]) if k in pieces[0]
                      else None) for k in _KEYS}
            emb = pipe.sam_model.encode_image(ex["sam_image"])
            p, s = pipe._decode_stage(
                emb, ex["coords"], ex["labels"], ex["boxes"], ex["valid"],
                ex["pred"], hw, mask_inputs=ex["mask_inputs"])
            preds.append(p)
            scores.append(s)
        return torch.cat(preds), torch.cat(scores)

    def __call__(self, queries: torch.Tensor, coarse_model_input,
                 microbatch: int = 4):
        """queries (N, 3, H, W), the same on every rank -> (preds (N, H,
        W), scores (N, K)) on every rank.  N is padded to a multiple of
        ``microbatch`` (which must divide by both stage sizes) with copies
        of the last slice, and the results cropped back."""
        inp = coarse_model_input
        n, m = queries.shape[0], microbatch
        if m % len(self.stage_a) or m % len(self.stage_b):
            raise ValueError("microbatch must divide by both stage sizes")
        pad = (-n) % m
        if pad:
            queries = torch.cat([queries, queries[-1:].expand(pad, -1, -1,
                                                              -1)])
        chunks = [queries[i:i + m] for i in range(0, queries.shape[0], m)]
        hw = tuple(queries.shape[-2:])
        local = None
        if self.rank in self.stage_a:
            self._stage_a(chunks, inp, m)
        elif self.rank in self.stage_b:
            p, s = self._stage_b(len(chunks), hw, m)
            local = (p.cpu(), s.cpu())
        # every rank returns the whole volume, B's rows in order
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (self.rank, local))
        by_rank = dict(got)
        rows = [by_rank[b] for b in self.stage_b]
        k = m // len(self.stage_b)
        preds, scores = [], []
        for c in range(len(chunks)):
            for p, s in rows:
                preds.append(p[c * k:(c + 1) * k])
                scores.append(s[c * k:(c + 1) * k])
        dev = queries.device
        return (torch.cat(preds)[:n].to(dev), torch.cat(scores)[:n].to(dev))
