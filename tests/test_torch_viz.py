"""The port's debug plots (``utils/viz.py``) against JAX's on the same
inputs: the port's given torch tensors, JAX's the numpy arrays; the images
written must be equal pixel for pixel."""

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import cv2
    from protosam_tpu.utils import viz as jviz
except ImportError:
    pass

from protosam_tpu_torch.utils import viz


def _inputs():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((40, 48)).astype(np.float32)
    pred = (rng.uniform(size=(40, 48)) > 0.6).astype(np.float32)
    labels = np.zeros((40, 48), np.int32)
    labels[5:15, 5:20], labels[25:35, 30:44] = 1, 2
    return {
        "plot_coarse_pred": dict(query_image=img, pred=pred,
                                 fg_prob=rng.uniform(size=(40, 48))),
        "plot_connected_components": dict(labels=labels, image=img),
        "plot_prompts": dict(image=img, pred=pred,
                             points=np.array([[[10.0, 12.0]], [[30.0, 8.0]]]),
                             point_labels=np.array([[1], [0]]),
                             boxes=np.array([[5.0, 5.0, 20.0, 15.0]])),
        "plot_pred_gt": dict(query_image=img, pred=pred, gt=labels > 0,
                             support_image=img.T.copy(),
                             support_mask=pred.T.copy(), score=0.75),
    }


@pytest.mark.parametrize("name", list(_inputs()))
def test_plots_match_jax(tmp_path, name):
    kw = _inputs()[name]
    ours = tmp_path / "port" / "a.png"
    theirs = tmp_path / "jax" / "a.png"
    getattr(viz, name)(**{k: torch.as_tensor(v) if isinstance(v, np.ndarray)
                          else v for k, v in kw.items()}, path=str(ours))
    getattr(jviz, name)(**kw, path=str(theirs))
    a, b = cv2.imread(str(ours)), cv2.imread(str(theirs))
    assert a is not None and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
