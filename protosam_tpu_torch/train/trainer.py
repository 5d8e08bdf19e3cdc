"""Episodic self-supervised training driver (JAX ``train/trainer.py``;
reference training.py:106-243).

Superpixel episodes from a thread-pool prefetcher (the reference's
DataLoader workers), the train step of ``train/step.py`` (weighted CE +
alignment loss, SGD + MultiStep decay or AdamW, gradient accumulation),
rolling snapshots with resume, JSONL metrics.  The model keeps f32 master
weights and computes in ``cfg.dtype`` (``cast_compute(...,
master_weights=True)``), as JAX's ``FewShotSeg(dtype=...)`` over f32 params
does; on the card DINOv2 runs kernels K1 and K2 forward and backward, and
the ALP match stays on its plain path (K5 has no backward).

The history records, beside the losses, the host's wait for the next batch
(``wait_ms``) apart from the step (``step_ms``, synchronised): the numpy
augmentation of large episodes may set the pace.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time

import numpy as np
import torch

from protosam_tpu_torch.data.superpixel import SuperpixelDataset
from protosam_tpu_torch.data.transforms import get_aug, transform_with_label
from protosam_tpu_torch.entry import set_f32_precision
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.layers import cast_compute
from protosam_tpu_torch.train.step import Batch, make_optimizer, train_step
from protosam_tpu_torch.utils.checkpoint import CheckpointManager
from protosam_tpu_torch.utils.config import Config
from protosam_tpu_torch.utils.synthetic import materialize

log = logging.getLogger("trainer")


def build_coarse_model(cfg: Config, device: torch.device | str = "cuda",
                       state_dict: dict | None = None) -> FewShotSeg:
    """``FewShotSeg`` of ``cfg`` on ``device`` (the card unless the caller
    asks for the CPU), with f32 master weights computing in ``cfg.dtype``:
    seeded synthetic weights from ``cfg.seed``, or ``state_dict`` (loaded
    strictly)."""
    if torch.device(device).type == "cuda":
        set_f32_precision()
    with torch.device("meta"):
        model = FewShotSeg(image_size=cfg.input_size[0],
                           which_model=cfg.modelname,
                           proto_grid_size=cfg.proto_grid_size)
    if state_dict is None:
        materialize(model, device, cfg.seed)
    else:
        model.to_empty(device=device)
        model.load_state_dict(state_dict)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return cast_compute(model, dtype, master_weights=True)


class EpisodePrefetcher:
    """Threaded episode producer (the reference's DataLoader workers):
    worker i picks episodes with ``RandomState(seed + i)``."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 seed: int = 0, depth: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.rngs = [np.random.RandomState(seed + i)
                     for i in range(max(num_workers, 1))]
        self.threads = [threading.Thread(target=self._work, args=(i,),
                                         daemon=True)
                        for i in range(max(num_workers, 1))]
        for t in self.threads:
            t.start()

    def _episode(self, rng):
        idx = int(rng.randint(0, len(self.dataset)))
        ep = self.dataset[idx]
        supp = np.stack([np.asarray(s) for s in ep["support_images"][0]])
        fg = np.stack([np.asarray(m["fg_mask"])
                       for m in ep["support_mask"][0]])
        bg = np.stack([np.asarray(m["bg_mask"])
                       for m in ep["support_mask"][0]])
        qry = np.stack([np.asarray(q) for q in ep["query_images"]])
        lbl = np.asarray(ep["query_labels"][0]).astype(np.int32)
        return supp, fg, bg, qry, lbl

    def _work(self, i):
        rng = self.rngs[i]
        while not self.stop.is_set():
            eps = [self._episode(rng) for _ in range(self.batch_size)]
            batch = tuple(np.stack([e[j] for e in eps]) for j in range(5))
            try:
                self.q.put(batch, timeout=1.0)
            except queue.Full:
                continue

    def __next__(self):
        return self.q.get()

    def close(self):
        self.stop.set()


def train(cfg: Config, max_steps: int | None = None,
          device: torch.device | str = "cuda",
          state_dict: dict | None = None) -> dict:
    """Train for ``max_steps`` (default ``cfg.n_steps``) steps on
    ``device``, resuming from the newest snapshot under
    ``cfg.log_dir/snapshots``.  A non-finite loss skips its update (JAX
    ``trainer.py:146-155``).  Returns the model, the optimizer, the step
    reached, the history (every ``print_interval`` steps and the last:
    loss, ce, align_loss, step, sps, step_ms, wait_ms), every step's
    ``step_ms`` and ``wait_ms``, and the count of skipped steps."""
    model = build_coarse_model(cfg, device, state_dict)
    dev = next(model.parameters()).device

    transforms = transform_with_label(get_aug(cfg.which_aug,
                                              cfg.input_size[0]))
    dataset = SuperpixelDataset(
        which_dataset=cfg.dataset.split("_")[0], base_dir=cfg.data_dir(),
        idx_split=cfg.eval_fold, mode="train", image_size=cfg.input_size[0],
        transforms=transforms, exclude_list=cfg.exclude_cls_list,
        superpix_scale=cfg.superpix_scale, use_clahe=cfg.use_clahe,
        use_3_slices=cfg.use_3_slices, seed=cfg.seed)

    opt = make_optimizer(model.parameters(), lr=cfg.lr,
                         momentum=cfg.momentum,
                         weight_decay=cfg.weight_decay,
                         lr_gamma=cfg.lr_step_gamma,
                         optim_type=cfg.optim_type,
                         accumulate=cfg.grad_accumulation_steps)
    step = 0
    ckpt = (CheckpointManager(os.path.join(cfg.log_dir, "snapshots"))
            if cfg.log_dir else None)
    if ckpt is not None:
        at = ckpt.restore(model, opt)
        if at is not None:
            step = at
            log.info("resumed from step %d", at)

    n_steps = max_steps if max_steps is not None else cfg.n_steps
    metrics_path = os.path.join(cfg.log_dir or ".", "train_metrics.jsonl")
    tb = None
    if cfg.log_dir:
        os.makedirs(cfg.log_dir, exist_ok=True)
        cfg.save(os.path.join(cfg.log_dir, "config.json"))
        cfg.snapshot_sources(cfg.log_dir)
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb = SummaryWriter(os.path.join(cfg.log_dir, "tboard"))
        except ImportError:
            tb = None

    align_weight = 1.0 if cfg.usealign else 0.0
    finite = lambda m: bool(torch.isfinite(m["loss"]))
    history, step_ms, wait_ms = [], [], []
    skipped = 0
    loader = EpisodePrefetcher(dataset, batch_size=max(cfg.batch_size, 1),
                               num_workers=cfg.num_workers, seed=cfg.seed)
    t0 = time.time()
    try:
        for it in range(step, n_steps):
            t_wait = time.perf_counter()
            batch = Batch.from_numpy(next(loader), dev)
            t_step = time.perf_counter()
            metrics = train_step(model, opt, batch, align_weight,
                                 apply_update=finite)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_end = time.perf_counter()
            wait_ms.append((t_step - t_wait) * 1e3)
            step_ms.append((t_end - t_step) * 1e3)
            if not finite(metrics):
                skipped += 1
                log.warning("skipping faulty batch at step %d "
                            "(non-finite loss, %d skipped total)",
                            it, skipped)
                continue
            step += 1
            if (it + 1) % cfg.print_interval == 0 or it == n_steps - 1:
                m_host = {k: float(v) for k, v in metrics.items()}
                m_host.update(step=it + 1,
                              sps=(it + 1) / (time.time() - t0),
                              step_ms=step_ms[-1], wait_ms=wait_ms[-1])
                history.append(m_host)
                log.info("step %d: %s", it + 1, m_host)
                if cfg.log_dir:
                    with open(metrics_path, "a") as f:
                        f.write(json.dumps(m_host) + "\n")
                if tb is not None:
                    for k in ("loss", "ce", "align_loss"):
                        tb.add_scalar(f"train/{k}", m_host[k], it + 1)
            if ckpt is not None and (it + 1) % cfg.save_snapshot_every == 0:
                ckpt.save(step, model, opt)
    finally:
        loader.close()
    if ckpt is not None:
        ckpt.save(step, model, opt)
    return {"model": model, "optimizer": opt, "step": step,
            "history": history, "step_ms": step_ms, "wait_ms": wait_ms,
            "skipped": skipped}
