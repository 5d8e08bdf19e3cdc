"""ProtoSAM pipeline: coarse prototypes -> device-side prompts -> SAM.

Behavioural spec: reference models/ProtoSAM.py:184-678.  Every stage runs
on the model's device, batched over slices, with no host round trip:

  coarse ALPNet logits
  -> f32 bilinear upsample to the SAM frame, softmax, argmax
  -> CCA (kernel K3) (+ keep-best-component 'cca' mode)
  -> per-component top-confidence/centroid points + boxes (padded)
  -> the reference's uint8 min-max renorm (floored) + SAM normalisation
  -> SAM encoder -> decoder batched over slices × components
  -> component masks OR-ed, composed bilinear->nearest resize to the query.

Traced (``utils/profiling.py``): ``forward_volume`` is a
``pipeline.volume`` span over ``pipeline.support_encode`` and, per batch,
``pipeline.coarse``, ``pipeline.prompts``, ``pipeline.sam_encoder`` and
``pipeline.decode``; each records CUDA events when tracing is enabled.

Flag semantics follow reference ProtoSAM.__init__:184-203 with the defaults
of validation_protosam.py:220-232.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from protosam_tpu_torch.models.io_protocol import (ALPNetInput, BOTH_MODE,
                                                   POINT_MODES)
from protosam_tpu_torch.models.sam.sam import preprocess as sam_preprocess
from protosam_tpu_torch.ops import launch_counts
from protosam_tpu_torch.ops.cca import components
from protosam_tpu_torch.ops.prompts import build_sam_prompts
from protosam_tpu_torch.ops.resize import (resize_bilinear,
                                           resize_bilinear_then_nearest,
                                           resize_nearest)
from protosam_tpu_torch.ops.rotate import (reverse_tensor,
                                           rotate_tensor_no_crop)
from protosam_tpu_torch.ops.tables import device_table
from protosam_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class ProtoSAMConfig:
    """Static pipeline flags (reference ProtoSAM.__init__:184-203)."""

    image_size: tuple[int, int] = (1024, 1024)
    num_points_for_sam: int = 1
    use_points: bool = True
    use_bbox: bool = True
    use_mask: bool = False
    # reproduce the reference's uint8 cast of the mask prompt, which wraps
    # its -8 background fill to 248 (predict_w_masks, ProtoSAM.py:479); off
    # by default, on to replay masks recorded through that cast
    mask_prompt_uint8_wrap: bool = False
    use_neg_points: bool = False
    use_cca: bool = True
    point_mode: str = BOTH_MODE
    coarse_pred_only: bool = False
    max_ccs: int = 8

    def __post_init__(self):
        if self.point_mode not in POINT_MODES:
            raise ValueError(f"point mode must be one of {POINT_MODES}")
        if not (self.use_bbox or self.use_points or self.use_mask):
            raise ValueError("must use at least one of bbox, points, or mask")


def _confidence_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per slice (reference util/utils.py:429-434) -> (B,)."""
    probs = torch.softmax(logits, dim=1)[:, 1].flatten(1)
    pred = (probs >= 0.5).float()
    return (probs * pred).sum(1) / (pred.sum(1) + 1e-6)


class ProtoSAM:
    """API parity with reference ProtoSAM: ``forward(query_image,
    coarse_model_input)`` -> ``(pred, scores)``.  Takes the coarse model
    and SAM as modules carrying their weights; runs where they live."""

    def __init__(self, coarse_model, sam_model,
                 config: ProtoSAMConfig = ProtoSAMConfig()):
        self.coarse_model = coarse_model
        self.sam_model = sam_model
        self.config = config

    @torch.no_grad()
    def _forward_core(self, supp, fg, bg, qrys, supp_fts, isval=True,
                      val_wsize=2):
        """Coarse model + refinement for a batch of query slices
        (N, 3, H, W) -> (preds (N, H, W), scores (N, K))."""
        with profiling.span("pipeline.coarse", device=qrys.device,
                            batch=qrys.shape[0]):
            logits = self.coarse_model(supp, fg, bg, qrys, isval, val_wsize,
                                       supp_fts=supp_fts)["logits"]
        return self._refine_core(qrys, logits)

    @torch.no_grad()
    def _forward_rotated(self, qry, inp: ALPNetInput, degrees: int):
        """Rotation TTA (reference ProtoSAM.py:543-556): the coarse logits
        of the rotated query, rotated back, refined on the query itself."""
        rotated, (rh, rw) = rotate_tensor_no_crop(qry, degrees)
        inp.set_query_images(rotated)
        logits = self.coarse_model(
            inp.supp_imgs, inp.fore_mask, inp.back_mask, rotated, inp.isval,
            inp.val_wsize, supp_fts=inp.supp_fts)["logits"]
        logits = reverse_tensor(logits, rh, rw, -degrees)
        inp.set_query_images(qry)
        return self._refine_core(qry, logits)

    def _refine_core(self, qrys, logits):
        cfg = self.config
        original_size = tuple(qrys.shape[-2:])
        if cfg.coarse_pred_only:
            pred = torch.argmax(logits, dim=1).float()
            if not cfg.use_cca:
                return pred, _confidence_from_logits(logits)[:, None]
            stats, conf = components(pred, torch.softmax(logits, dim=1)[:, 1],
                                     cfg.max_ccs, True)
            return (stats.labels > 0) * pred, conf
        dev, b = qrys.device, qrys.shape[0]
        with profiling.span("pipeline.prompts", device=dev, batch=b):
            ex = self._extract_prompts(qrys, logits)
        with profiling.span("pipeline.sam_encoder", device=dev, batch=b):
            emb = self.sam_model.encode_image(ex["sam_image"])
        with profiling.span("pipeline.decode", device=dev, batch=b):
            return self._decode_stage(
                emb, ex["coords"], ex["labels"], ex["boxes"], ex["valid"],
                ex["pred"], original_size, mask_inputs=ex["mask_inputs"])

    def _coarse_components(self, qrys, logits):
        """The front both pipelines share, for B slices: the queries and
        the coarse logits in the SAM frame, the softmax, its argmax and the
        components that become prompts ('cca' mode: the most confident
        one).  Returns (qimg, probs, pred (B, H, W), stats)."""
        cfg = self.config
        qimg = resize_bilinear(qrys, cfg.image_size)
        # f32 logit upsample + softmax + argmax: the argmax seeds CCA and
        # every prompt, so its precision decides mask boundaries
        probs = torch.softmax(resize_bilinear(logits.float(),
                                              cfg.image_size), dim=1)
        pred = torch.argmax(probs, dim=1).float()
        stats, _ = components(pred, probs[:, 1], cfg.max_ccs, cfg.use_cca)
        return qimg, probs, pred, stats

    def _extract_prompts(self, qrys, logits):
        """Device-side prompt extraction for B slices: coarse logits ->
        CCA -> points/boxes, plus the preprocessed SAM input images."""
        cfg = self.config
        qimg, probs, pred, stats = self._coarse_components(qrys, logits)
        b, k = stats.valid.shape
        if cfg.use_points:
            pts = build_sam_prompts(
                probs[:, 1], probs[:, 0], stats,
                num_points=cfg.num_points_for_sam, point_mode=cfg.point_mode,
                use_neg_points=cfg.use_neg_points)
            coords, labels = pts.coords, pts.labels
        else:
            coords = torch.zeros((b, k, 1, 2), device=pred.device)
            labels = torch.full((b, k, 1), -1, dtype=torch.int32,
                                device=pred.device)
        boxes = stats.bboxes.float() if cfg.use_bbox else None

        mask_inputs = None
        if cfg.use_mask:
            # per-component low-res mask prompts (4x the embedding grid),
            # fg -> 10 / bg -> -8 (reference predict_w_masks, :468-479), or
            # bg -> 248 with mask_prompt_uint8_wrap, as its uint8 cast gives
            side = 4 * (self.sam_model.image_size
                        // self.sam_model.vit_patch_size)
            low = resize_nearest(stats.onehot().float(), (side, side))
            bg_fill = 248.0 if cfg.mask_prompt_uint8_wrap else -8.0
            mask_inputs = torch.where(low > 0.5, 10.0, bg_fill)[:, :, None]

        # the SAM input: the reference's uint8 min-max renorm quirk
        # (ProtoSAM.py:651-660), floor to uint8 steps, then the predictor's
        # own pixel normalisation
        lo = qimg.amin(dim=(1, 2, 3), keepdim=True)
        hi = qimg.amax(dim=(1, 2, 3), keepdim=True)
        q = torch.floor((qimg - lo) / (hi - lo) * 255.0)
        q = sam_preprocess(q, self.sam_model.image_size)
        return {"sam_image": q, "coords": coords, "labels": labels,
                "boxes": boxes, "valid": stats.valid, "pred": pred,
                "mask_inputs": mask_inputs}

    def _decode_stage(self, emb, coords, labels, boxes, valid, pred,
                      original_size, mask_inputs=None):
        """Batched SAM decode over (B slices × K components).

        emb (B, 256, 64, 64); coords (B, K, P, 2); labels (B, K, P);
        boxes (B, K, 4) | None; valid (B, K); pred (B, Hs, Ws).
        Returns (out (B, H, W), scores (B, K)).
        """
        cfg = self.config
        b, k = coords.shape[:2]
        emb_rep = emb.repeat_interleave(k, dim=0)
        flat = lambda x: x.reshape((b * k,) + tuple(x.shape[2:]))
        if cfg.use_mask and mask_inputs is not None:
            # mask prompts only, multimask output, best score per component
            n = b * k
            low_res, iou = self.sam_model.decode(
                emb_rep, coords.new_zeros((n, 0, 2)),
                labels.new_zeros((n, 0)), None, flat(mask_inputs), True,
                False)
            best = torch.argmax(iou, dim=1)
            rows = torch.arange(n, device=iou.device)
            masks_low = low_res[rows, best].reshape(b, k,
                                                    *low_res.shape[-2:])
            scores = iou[rows, best].reshape(b, k)
        else:
            # multimask unless cca mode (reference :522); best index 0
            low_res, iou = self.sam_model.decode(
                emb_rep, flat(coords), flat(labels),
                None if boxes is None else flat(boxes), None,
                not cfg.use_cca, boxes is None)
            masks_low = low_res[:, 0].reshape(b, k, *low_res.shape[-2:])
            scores = iou[:, 0].reshape(b, k)

        # postprocess: bilinear to the SAM frame (the pip predictor the
        # reference drives), then nearest to the query frame, composed
        size = (self.sam_model.image_size,) * 2
        masks = resize_bilinear_then_nearest(masks_low, size, original_size)
        return self._compose(masks > 0.0, scores, valid, pred, original_size)

    @staticmethod
    def _compose(fg, scores, valid, pred, original_size):
        """The tail both pipelines share: the components' masks ``fg``
        (B, K, H, W) bool OR-ed over the valid ones, with their scores
        (B, K); a slice whose coarse prediction ``pred`` is empty returns
        it, resized to the query, with scores 0 (reference :612-613)."""
        seg = (fg & valid[:, :, None, None]).any(dim=1).float()
        empty = torch.amax(pred, dim=(1, 2)) == 0
        out = torch.where(empty[:, None, None],
                          resize_nearest(pred, original_size), seg)
        return out, torch.where(empty[:, None], 0.0, scores * valid)

    def forward_volume(self, queries: torch.Tensor,
                       coarse_model_input: ALPNetInput,
                       slice_batch: int = 8):
        """Segment a slice stack: queries (N, 3, H, W) -> (preds (N, H, W),
        scores (N, K)).  The support set is encoded once per volume; N is
        padded to a multiple of ``slice_batch``.  One ``pipeline.volume``
        span, which counts the slices, the padded ones, the kernels'
        launches (K1-K9, from each wrapper's ``launches``) and the
        shape-only tables built (``tables``, from ``device_table.builds``:
        0 once a call of the same shapes has run)."""
        inp = coarse_model_input
        dev, n = queries.device, queries.shape[0]
        pad = (-n) % slice_batch
        with profiling.span("pipeline.volume", device=dev, slices=n,
                            padded=pad) as vol:
            before = launch_counts()
            tables = device_table.builds
            supp_fts = inp.supp_fts
            if supp_fts is None:
                with profiling.span("pipeline.support_encode", device=dev,
                                    batch=inp.supp_imgs.shape[0]), \
                        torch.no_grad():
                    supp_fts = self.coarse_model.get_features(inp.supp_imgs)
            if pad:
                queries = torch.cat([queries, queries[-1:].expand(pad, -1, -1,
                                                                  -1)])
            preds, scores = [], []
            for i in range(0, queries.shape[0], slice_batch):
                p, s = self._forward_core(
                    inp.supp_imgs, inp.fore_mask, inp.back_mask,
                    queries[i:i + slice_batch], supp_fts, True, inp.val_wsize)
                preds.append(p)
                scores.append(s)
            vol.attrs["launches"] = {
                k: c - before[k] for k, c in launch_counts().items()
                if c != before[k]}
            vol.attrs["tables"] = device_table.builds - tables
        return torch.cat(preds)[:n], torch.cat(scores)[:n]

    def _mesh_pipeline(self, mesh, shard_params: bool) -> "ProtoSAM":
        """This pipeline, or for ``shard_params`` a copy whose encoders
        hold this rank's Megatron shards (``parallel.
        encoder_param_sharding``), cached on the grid's shape and this
        rank's place in it and on the weights' identities and
        ``_version``s, so a weight swap (in place or by new tensors)
        builds the copy anew: JAX's cache (``protosam.py:500-518``) keys on
        the mesh only and serves the old weights after a swap.  The
        row-parallel layers take ``mesh``'s model group at every call."""
        if not shard_params or mesh.n_model == 1:
            return self
        from protosam_tpu_torch.parallel.sharding import (
            RowParallelLinear, encoder_param_sharding)

        weights = tuple((id(p), p._version) for m in (self.coarse_model,
                                                      self.sam_model)
                        for p in m.parameters())
        key = (mesh.n_data, mesh.n_model, mesh.data_rank, mesh.model_rank,
               weights)
        cached = getattr(self, "_mesh_pipe", None)
        if cached is None or cached[0] != key:
            self._mesh_pipe = None  # free the old copy first
            coarse = copy.deepcopy(self.coarse_model)
            sam = copy.deepcopy(self.sam_model)
            encoder_param_sharding(coarse, mesh)
            encoder_param_sharding(sam, mesh)
            self._mesh_pipe = (key, type(self)(coarse, sam, self.config))
        pipe = self._mesh_pipe[1]
        for m in (pipe.coarse_model, pipe.sam_model):
            for layer in m.modules():
                if isinstance(layer, RowParallelLinear):
                    layer.group = mesh.model_group
        return pipe

    def forward_volume_sharded(self, queries: torch.Tensor,
                               coarse_model_input: ALPNetInput, mesh,
                               slice_batch: int | None = None,
                               shard_params: bool = False):
        """Multi-GPU volume inference (JAX ``forward_volume_sharded``), one
        process a rank of ``mesh`` (``parallel.make_mesh``), each given the
        same ``queries`` (N, 3, H, W).  ``slice_batch`` (default the data
        size) is rounded up to a multiple of the data size and split over
        the data ranks; N is padded to a multiple of it, each data rank
        runs ``forward_volume`` on its contiguous block with no collective,
        and the preds and scores are then all-gathered over the data
        group, so every rank returns the whole volume, as JAX's global
        array is.

        ``shard_params=True`` Megatron-shards both encoders over the model
        axis (tensor parallelism: the ranks of a model group run the same
        slices on their shards and all-reduce each row-parallel output).
        Returns (preds (N, H, W), scores (N, K))."""
        from protosam_tpu_torch.parallel.sharding import all_gather

        pipe = self._mesh_pipeline(mesh, shard_params)
        n = queries.shape[0]
        local = -(-(slice_batch or mesh.n_data) // mesh.n_data)
        pad = (-n) % (local * mesh.n_data)
        if pad:
            queries = torch.cat([queries, queries[-1:].expand(pad, -1, -1,
                                                              -1)])
        block = queries.shape[0] // mesh.n_data
        lo = mesh.data_rank * block
        preds, scores = pipe.forward_volume(queries[lo:lo + block],
                                            coarse_model_input,
                                            slice_batch=local)
        return tuple(torch.cat(all_gather(x, mesh.data_group))[:n]
                     for x in (preds, scores))

    def forward(self, query_image: torch.Tensor,
                coarse_model_input: ALPNetInput, degrees_rotate: int = 0):
        """(pred (H, W), scores (K,)) for one query (1, 3, H, W) —
        reference ProtoSAM.forward.  ``degrees_rotate != 0`` takes the
        coarse logits from the rotated query (``_forward_rotated``)."""
        inp = coarse_model_input
        if degrees_rotate != 0:
            pred, scores = self._forward_rotated(query_image, inp,
                                                 degrees_rotate)
            return pred[0], scores[0]
        inp.set_query_images(query_image)
        pred, scores = self._forward_core(
            inp.supp_imgs, inp.fore_mask, inp.back_mask, inp.qry_imgs,
            inp.supp_fts, inp.isval, inp.val_wsize)
        return pred[0], scores[0]

    __call__ = forward
