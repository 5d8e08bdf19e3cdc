"""Test-time training (JAX ``eval/ttt.py``; reference validation.py:39-97).

Fine-tune the coarse model on one query slice with its own coarse
prediction as the pseudo-label: each step draws two independent
augmentations of (image, prediction) as a (support, query) episode and
takes the train step (weighted CE + alignment loss).  The model is trained
in place; the caller restores its weights when ``reset_after_slice`` is
set (reference validation.py:279-281).
"""

from __future__ import annotations

import numpy as np

from protosam_tpu_torch.data.transforms import get_aug, transform_with_label
from protosam_tpu_torch.train.step import Batch, make_optimizer, train_step


def test_time_training(model, image: np.ndarray, prediction: np.ndarray, *,
                       n_steps: int = 20, which_aug: str = "sabs_aug",
                       lr: float = 1e-3, optim_type: str = "sgd",
                       align_weight: float = 1.0, seed: int = 0):
    """image (C, H, W), prediction (H, W) binary, numpy.  ``n_steps``
    steps of a fresh optimizer on ``model``'s parameters; returns the
    model."""
    tr = transform_with_label(get_aug(which_aug, image.shape[-1]),
                              rng=np.random.RandomState(seed))
    comp = np.concatenate([image.transpose(1, 2, 0),
                           prediction[..., None]], axis=-1)
    opt = make_optimizer(model.parameters(), lr=lr, optim_type=optim_type)
    dev = next(model.parameters()).device
    c_img = image.shape[0]
    for _ in range(n_steps):
        q_img, q_lbl = tr(comp, c_img=c_img, c_label=1, nclass=2,
                          use_onehot=False)
        s_img, s_lbl = tr(comp, c_img=c_img, c_label=1, nclass=2,
                          use_onehot=False)
        batch = Batch.from_numpy((
            s_img.transpose(2, 0, 1)[None, None].astype(np.float32),
            s_lbl[..., 0][None, None].astype(np.float32),
            (1.0 - s_lbl[..., 0])[None, None].astype(np.float32),
            q_img.transpose(2, 0, 1)[None, None].astype(np.float32),
            q_lbl[..., 0][None].astype(np.int32)), dev)
        train_step(model, opt, batch, align_weight)
    return model
