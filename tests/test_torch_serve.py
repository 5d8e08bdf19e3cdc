"""The port's HTTP server (``protosam_tpu_torch/serve.py``) over
127.0.0.1:0 on the CPU: the flow of ``tests/test_serve.py``, its masks
bit-equal to the port's own ``forward`` / ``forward_volume`` on the same
build, and at Dice >= 0.99 against JAX's server on the same weights
(dinov2_t14 at 126 px + SAM vit_t at a 256 frame, f32)."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    from protosam_tpu.models.alpnet import FewShotSeg as JFewShotSeg
    from protosam_tpu.models.sam import build_sam as jbuild_sam
    from protosam_tpu.pipeline import ProtoSAM as JProtoSAM
    from protosam_tpu.pipeline import ProtoSAMConfig as JConfig
    from protosam_tpu.serve import serve as jserve
except ImportError:
    pass

from torch_parity import (dice, jax_coarse_params, jax_sam_params,
                          seeded_state_dict)

from protosam_tpu_torch.entry import build_pipeline
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.io_protocol import ALPNetInput
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.pipeline.protosam import ProtoSAMConfig
from protosam_tpu_torch.serve import serve

torch.set_num_threads(2)

SIZE, N_VOLUME = 126, 3
DICE_BAR = 0.99


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers():
    """The port's server and JAX's, on the same seeded weights."""
    csd = seeded_state_dict(FewShotSeg(image_size=SIZE,
                                       which_model="dinov2_t14"), 0)
    ssd = seeded_state_dict(build_sam("vit_t", image_size=256), 1)
    pipe = build_pipeline("cpu", sam_ver="vit_t", coarse="dinov2_t14",
                          image_size=SIZE, sam_size=256, dtype=torch.float32,
                          config=ProtoSAMConfig(image_size=(256, 256),
                                                max_ccs=4),
                          coarse_state=csd, sam_state=ssd)
    jpipe = JProtoSAM(JFewShotSeg(image_size=SIZE, which_model="dinov2_t14"),
                      jax_coarse_params(csd), jbuild_sam("vit_t",
                                                         image_size=256),
                      jax_sam_params(ssd),
                      JConfig(image_size=(256, 256), use_cca=True,
                              max_ccs=4))
    ours = serve(pipe, host="127.0.0.1", port=0, slice_batch=2)
    theirs = jserve(jpipe, host="127.0.0.1", port=0, slice_batch=2)
    yield pipe, ours, _start(ours), _start(theirs)
    ours.shutdown()
    theirs.shutdown()


def _post(url, payload):
    req = urllib.request.Request(url, data=payload, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _inputs():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((1, 3, SIZE, SIZE)).astype(np.float32)
    masks = np.zeros((1, SIZE, SIZE), np.float32)
    masks[:, 30:80, 30:80] = 1
    # smooth queries (the support's structure plus noise), so the coarse
    # masks are neither empty nor everywhere
    queries = (images + 0.3 * rng.standard_normal(
        (N_VOLUME, 3, SIZE, SIZE))).astype(np.float32)
    return images, masks, queries


@pytest.fixture(scope="module")
def flow(servers):
    """The flow of ``tests/test_serve.py`` against both servers: health,
    a segment before any support (refused), the support, one slice and a
    volume; every response kept."""
    pipe, httpd, url, jurl = servers
    out = {}
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        out["health_before"] = json.loads(r.read())
    try:
        _post(url + "/segment", _npy(np.zeros((3, SIZE, SIZE), np.float32)))
        out["early_segment"] = 200
    except urllib.error.HTTPError as e:
        out["early_segment"] = e.code
    images, masks, queries = _inputs()
    buf = io.BytesIO()
    np.savez(buf, images=images, masks=masks)
    for u in (url, jurl):
        _post(u + "/register_support", buf.getvalue())
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        out["health_after"] = json.loads(r.read())
    for tag, u in (("", url), ("jax_", jurl)):
        out[tag + "single"] = np.load(io.BytesIO(
            _post(u + "/segment", _npy(queries[0]))))
        out[tag + "volume"] = np.load(io.BytesIO(
            _post(u + "/segment", _npy(queries))))
    return out


def test_serve_flow(servers, flow):
    httpd = servers[1]
    assert flow["health_before"] == {"status": "ok", "device": "cpu",
                                     "device_name": "cpu",
                                     "support_registered": False}
    assert flow["early_segment"] == 400  # a clean error before support
    assert flow["health_after"]["support_registered"]
    # encoded once, in the request thread, under inference mode
    supp_fts = httpd.service.inp.supp_fts
    assert supp_fts is not None and torch.is_inference(supp_fts)
    assert flow["single"].shape == (SIZE, SIZE)
    assert set(np.unique(flow["single"])) <= {0, 1}
    assert flow["volume"].shape == (N_VOLUME, SIZE, SIZE)
    assert 0 < flow["volume"].mean() < 1


def test_serve_masks_are_the_pipelines(servers, flow):
    """Bit-equal to the pipeline's own ``forward_volume`` and ``forward``
    on the same build and inputs."""
    pipe = servers[0]
    images, masks, queries = _inputs()
    inp = ALPNetInput(torch.from_numpy(images), torch.from_numpy(masks),
                      torch.from_numpy(images[:1]))
    want_volume, _ = pipe.forward_volume(torch.from_numpy(queries), inp,
                                         slice_batch=2)
    want_single, _ = pipe.forward(torch.from_numpy(queries[:1]), inp)
    np.testing.assert_array_equal(flow["volume"], want_volume.numpy())
    np.testing.assert_array_equal(flow["single"], want_single.numpy())


def test_serve_masks_match_jax_server(flow):
    """JAX's server on the same weights: Dice >= 0.99 a slice."""
    assert dice(flow["single"], flow["jax_single"]) >= DICE_BAR
    for a, b in zip(flow["volume"], flow["jax_volume"]):
        assert dice(a, b) >= DICE_BAR


def test_serve_reports_bad_requests(servers):
    _, _, url, _ = servers
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url + "/register_support", b"not an npz")
    assert err.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url + "/nowhere", b"")
    assert err.value.code == 404
