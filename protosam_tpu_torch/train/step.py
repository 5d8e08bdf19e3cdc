"""Episodic self-supervised training step for the ALPNet coarse model (JAX
``train/step.py``; reference training.py:147-208): weighted cross-entropy
(class weights [0.05, 1.0], ignore label 255) plus the PANet alignment
loss, SGD with momentum and the MultiStep decay (gamma 0.95 every 1000
updates) or AdamW, and gradient accumulation.

The optimizers are written here with optax's update order, so a step
gives the params JAX gives: ``add_decayed_weights`` then ``sgd``
(momentum trace, then ``-lr``), or ``adamw`` (``scale_by_adam``, then the
decay, then ``-lr``), the schedule read at the count of updates made so
far; ``Accumulate`` is ``optax.MultiSteps`` (the running mean of k
gradients, one update every k calls).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

CE_WEIGHTS = (0.05, 1.0)  # reference config_ssl_upload / training.py:158-160
IGNORE_LABEL = 255


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                weights=CE_WEIGHTS) -> torch.Tensor:
    """``CrossEntropyLoss(weight=[0.05, 1.0], ignore_index=255)`` of (B, 2,
    H, W) logits against (B, H, W) integer labels: the weighted mean
    divides by the sum of the weights of the kept targets (JAX
    ``step.py:33-46``)."""
    logp = torch.log_softmax(logits.float(), dim=1)
    valid = labels != IGNORE_LABEL
    safe = labels.clamp(0, logits.shape[1] - 1).long()
    picked = torch.gather(logp, 1, safe[:, None])[:, 0]
    w = torch.tensor(weights, dtype=torch.float32,
                     device=logits.device)[safe] * valid
    return -(picked * w).sum() / torch.clamp(w.sum(), min=1e-8)


def _schedule(lr: float, gamma: float, every: int):
    return lambda count: lr * gamma ** (count // every)


class SGD:
    """optax ``chain(add_decayed_weights(wd), sgd(sched, momentum))``:
    ``g += wd·p``; ``t = g + momentum·t``; ``p += -sched(count)·t``."""

    def __init__(self, params, lr, momentum, weight_decay, schedule):
        self.params = list(params)
        self.momentum, self.weight_decay = momentum, weight_decay
        self.schedule = schedule
        self.count = 0
        self.trace = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        lr = self.schedule(self.count)
        for p, g, t in zip(self.params, grads, self.trace):
            if g is None:
                continue
            g = g + self.weight_decay * p
            t.copy_(g + self.momentum * t)
            p.add_(-lr * t)
        self.count += 1

    def state_dict(self):
        return {"count": self.count, "trace": self.trace}

    def load_state_dict(self, sd):
        self.count = sd["count"]
        for t, v in zip(self.trace, sd["trace"]):
            t.copy_(v)


class AdamW:
    """optax ``adamw(sched, b1=0.9, b2=0.999, eps=1e-8, weight_decay)``:
    ``scale_by_adam`` (moments, then bias correction at count + 1), plus
    ``wd·p``, times ``-sched(count)``.  ``torch.optim.AdamW`` decays the
    params before the Adam step instead."""

    def __init__(self, params, lr, weight_decay, schedule, b1=0.9,
                 b2=0.999, eps=1e-8):
        self.params = list(params)
        self.weight_decay, self.schedule = weight_decay, schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        lr = self.schedule(self.count)
        n = self.count + 1
        # optax's bias correction, 1 - decay**count, in f32
        c1 = 1 - torch.tensor(self.b1) ** n
        c2 = 1 - torch.tensor(self.b2) ** n
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            if g is None:
                continue
            c1, c2 = c1.to(p.device), c2.to(p.device)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(-lr * u)
        self.count = n

    def state_dict(self):
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, sd):
        self.count = sd["count"]
        for dst, src in ((self.mu, sd["mu"]), (self.nu, sd["nu"])):
            for t, v in zip(dst, src):
                t.copy_(v)


class Accumulate:
    """``optax.MultiSteps(opt, k)``: a running mean of the gradients
    (``acc + (g - acc) / (n + 1)``), handed to ``opt`` every k-th call;
    the other calls leave the params as they are."""

    def __init__(self, opt, every: int):
        self.opt, self.every = opt, every
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in opt.params]

    @torch.no_grad()
    def step(self, grads):
        used = [g is not None for g in grads]
        for a, g in zip(self.acc, grads):
            if g is not None:
                a.add_((g - a) / (self.mini_step + 1))
        if self.mini_step == self.every - 1:
            self.opt.step([a if u else None
                           for a, u in zip(self.acc, used)])
            for a in self.acc:
                a.zero_()
        self.mini_step = (self.mini_step + 1) % self.every

    def state_dict(self):
        return {"mini_step": self.mini_step, "acc": self.acc,
                "inner": self.opt.state_dict()}

    def load_state_dict(self, sd):
        self.mini_step = sd["mini_step"]
        for t, v in zip(self.acc, sd["acc"]):
            t.copy_(v)
        self.opt.load_state_dict(sd["inner"])


def make_optimizer(params, lr: float = 1e-3, momentum: float = 0.9,
                   weight_decay: float = 5e-4, lr_gamma: float = 0.95,
                   lr_step_every: int = 1000, optim_type: str = "sgd",
                   accumulate: int = 1):
    """SGD with momentum and MultiStepLR(every 1000, gamma 0.95)
    (reference training.py:147-156) or AdamW over ``params``, wrapped in
    ``Accumulate`` when ``accumulate`` > 1."""
    sched = _schedule(lr, lr_gamma, lr_step_every)
    if optim_type == "sgd":
        opt = SGD(params, lr, momentum, weight_decay, sched)
    else:
        opt = AdamW(params, lr, weight_decay, sched)
    return Accumulate(opt, accumulate) if accumulate > 1 else opt


@dataclass
class Batch:
    """One batch of episodes (leading axis B):
      supp (B, S, 3, H, W), fg / bg (B, S, H, W) support masks,
      qry (B, 1, 3, H, W), lbl (B, H, W) integer (255 = ignore)."""

    supp: torch.Tensor
    fg: torch.Tensor
    bg: torch.Tensor
    qry: torch.Tensor
    lbl: torch.Tensor

    @classmethod
    def from_numpy(cls, arrays, device) -> "Batch":
        return cls(*(torch.as_tensor(a).to(device) for a in arrays))


def episode_loss(model, supp, fg, bg, qry, lbl, align_weight: float,
                 val_wsize: int):
    """One episode: the training forward (``isval=False``), weighted CE
    against the query label, plus ``align_weight`` × the alignment loss
    over the upsampled logits (JAX ``step.py:73-82``)."""
    out = model(supp, fg, bg, qry, isval=False, val_wsize=val_wsize)
    logits = out["logits"]
    ce = weighted_ce(logits, lbl[None])
    align = model.align_loss(out["qry_fts"], logits, out["supp_fts"], fg,
                             bg, model.kernel_size)
    return ce + align_weight * align, ce, align


def train_step(model, opt, batch: Batch, align_weight: float = 1.0,
               val_wsize: int = 2, apply_update=None) -> dict:
    """Mean of the episodes' losses, its gradients, and the optimizer
    update (JAX ``make_train_step``).  Returns the f32 ``loss``, ``ce`` and
    ``align_loss``.  ``apply_update(metrics)`` decides whether the update
    is applied (the trainer skips it on a non-finite loss)."""
    params = [p for p in model.parameters() if p.requires_grad]
    n = batch.supp.shape[0]
    losses, ces, aligns = [], [], []
    for i in range(n):
        loss, ce, align = episode_loss(
            model, batch.supp[i], batch.fg[i], batch.bg[i], batch.qry[i],
            batch.lbl[i], align_weight, val_wsize)
        losses.append(loss)
        ces.append(ce.detach())
        aligns.append(align.detach())
    loss = torch.stack(losses).mean()
    # params the loss never reaches (DINOv2's mask_token) get no gradient
    # and no update, as in the reference and in JAX, which has no such leaf
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    metrics = {"loss": loss.detach(), "ce": torch.stack(ces).mean(),
               "align_loss": torch.stack(aligns).mean()}
    if apply_update is None or apply_update(metrics):
        opt.step(grads)
    return metrics
