"""Reference-layout ``.pth`` snapshots into the port, against the JAX
package's loader on the same files: SAM, a DINOv2 hub state_dict, a
HuggingFace DINOv2 one, an ALPNet snapshot (``encoder.``-prefixed) and a
``{"state_dict": ...}`` wrapper, at tiny widths.  JAX's
``load_torch_snapshot`` of each file, taken back to a state_dict by the
port's converters, must give the port's tensors.  Also: the port's ViT-H
SAM and DINOv2-L/14 have the reference's keys and shapes, and
``build_models`` with ``reload_model_path`` gives the in-memory build's
masks."""

import dataclasses
import json
import pathlib
import sys

import numpy as np

import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    from protosam_tpu.eval import protosam_eval as jeval
    from protosam_tpu.utils import checkpoint as jcheckpoint
    from protosam_tpu.utils import torch_convert as jconvert
    from protosam_tpu.utils.config import Config as JConfig
except ImportError:
    pass

from torch_parity import seeded_state_dict

from protosam_tpu_torch.eval import protosam_eval
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.dinov2.vit import build_dinov2
from protosam_tpu_torch.models.io_protocol import ALPNetInput
from protosam_tpu_torch.models.sam.registry import build_sam
from protosam_tpu_torch.ops.resize import resize_bilinear
from protosam_tpu_torch.pipeline.protomedsam import ProtoMedSAM
from protosam_tpu_torch.utils import checkpoint, convert
from protosam_tpu_torch.utils.config import Config

torch.set_num_threads(2)

MANIFESTS = pathlib.Path(__file__).parent / "goldens" / "manifests"
VIT_T_GLOBAL = (1,)  # the port's and JAX's vit_t global block


def _hub_to_hf(sd):
    """A DINOv2 hub state_dict in HuggingFace ``Dinov2Model`` names."""
    out = {"embeddings.cls_token": sd["cls_token"],
           "embeddings.mask_token": sd["mask_token"],
           "embeddings.position_embeddings": sd["pos_embed"],
           "layernorm.weight": sd["norm.weight"],
           "layernorm.bias": sd["norm.bias"]}
    for kind in ("weight", "bias"):
        out[f"embeddings.patch_embeddings.projection.{kind}"] = \
            sd[f"patch_embed.proj.{kind}"]
    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        b, p = f"blocks.{i}.", f"encoder.layer.{i}."
        for kind in ("weight", "bias"):
            q, k, v = sd[f"{b}attn.qkv.{kind}"].chunk(3)
            for n, w in (("query", q), ("key", k), ("value", v)):
                out[f"{p}attention.attention.{n}.{kind}"] = w.clone()
            out[f"{p}attention.output.dense.{kind}"] = \
                sd[f"{b}attn.proj.{kind}"]
            for name in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
                out[f"{p}{name}.{kind}"] = sd[f"{b}{name}.{kind}"]
        out[f"{p}layer_scale1.lambda1"] = sd[f"{b}ls1.gamma"]
        out[f"{p}layer_scale2.lambda1"] = sd[f"{b}ls2.gamma"]
        i += 1
    return out


@pytest.fixture(scope="module")
def states():
    dino = seeded_state_dict(build_dinov2("dinov2_vitt14"), 0)
    sam = seeded_state_dict(build_sam("vit_t", image_size=256), 1)
    return dino, sam


def _assert_same(got, want, skip=()):
    assert set(got) - set(skip) == set(want) - set(skip)
    for k in want:
        if k not in skip:
            torch.testing.assert_close(got[k], want[k], atol=0, rtol=0,
                                       msg=k)


def _jax_as_state_dict(params, layout):
    """JAX's loaded params back to a state_dict by the port's converters."""
    if layout == "sam":
        return convert.sam_state_dict(params, VIT_T_GLOBAL)
    if layout == "alpnet":
        return convert.fewshot_state_dict(params)
    return convert.dinov2_state_dict(params)


@pytest.mark.parametrize("layout,wrap", [
    ("sam", False), ("hub", False), ("alpnet", False), ("alpnet", True),
    ("sam", True)], ids=["sam", "dinov2-hub", "alpnet", "alpnet-wrapped",
                         "sam-wrapped"])
def test_snapshot_loads_as_jax_loads_it(tmp_path, states, layout, wrap):
    dino, sam = states
    sd = {"sam": sam, "hub": dino,
          "alpnet": {**{f"encoder.{k}": v for k, v in dino.items()}}}[layout]
    path = str(tmp_path / "snap.pth")
    torch.save({"state_dict": sd} if wrap else sd, path)

    got = checkpoint.load_params(path)
    _assert_same(got, sd)
    module = {"sam": lambda: build_sam("vit_t", image_size=256),
              "hub": lambda: build_dinov2("dinov2_vitt14"),
              "alpnet": lambda: FewShotSeg(image_size=126,
                                           which_model="dinov2_t14")}[layout]()
    module.load_state_dict(got)  # strict
    _assert_same(module.state_dict(), sd)

    want = _jax_as_state_dict(jcheckpoint.load_torch_snapshot(path), layout)
    # JAX has no mask_token (unused at inference); its converter gives 0s
    _assert_same(got, want, skip={"mask_token", "encoder.mask_token"})


def test_alpnet_snapshot_drops_what_is_not_the_encoder(tmp_path, states):
    dino, _ = states
    sd = {f"encoder.{k}": v for k, v in dino.items()}
    torch.save({**sd, "epoch_marker": torch.ones(1)}, tmp_path / "a.pth")
    _assert_same(checkpoint.load_torch_snapshot(str(tmp_path / "a.pth")), sd)


def test_hf_dinov2_maps_as_jax_maps_it(states):
    dino, _ = states
    hf = _hub_to_hf(dino)
    got = convert.hf_dinov2_to_hub_state_dict(hf)
    _assert_same(got, dino)
    build_dinov2("dinov2_vitt14").load_state_dict(got)  # strict
    jhub = jconvert.hf_dinov2_to_hub_state_dict(
        {k: v.numpy() for k, v in hf.items()})
    _assert_same(convert.dinov2_state_dict(jconvert.convert_dinov2(jhub)),
                 dino, skip={"mask_token"})


@pytest.mark.parametrize("prefix", ["", "encoder."], ids=["bare",
                                                          "alpnet"])
def test_deeplab_snapshot_names_its_roadmap_item(tmp_path, prefix):
    """ROADMAP §1 item 14 is done: a DeepLab ResNet-101 snapshot, bare or
    ALPNet-prefixed, loads as ``FewShotSeg``'s encoder keys, without
    torchvision's ``num_batches_tracked`` counters."""
    torch.save({f"{prefix}backbone.conv1.weight": torch.zeros(2, 3, 1, 1),
                f"{prefix}backbone.bn1.num_batches_tracked": torch.tensor(3),
                f"{prefix}localconv.weight": torch.zeros(2, 2, 1, 1)},
               tmp_path / "r.pth")
    sd = checkpoint.load_params(str(tmp_path / "r.pth"))
    assert sorted(sd) == ["encoder.backbone.conv1.weight",
                          "encoder.localconv.weight"]


def test_orbax_directory_is_refused(tmp_path):
    """A directory that holds no orbax checkpoint is refused, and says so
    (orbax checkpoints themselves are read: the tests below)."""
    with pytest.raises(FileNotFoundError, match="orbax"):
        checkpoint.load_params(str(tmp_path))


@pytest.mark.parametrize("kind", ["alpnet", "sam"])
def test_orbax_params_load_as_converted(tmp_path, states, kind):
    """A checkpoint JAX's ``save_params`` wrote loads into the port's
    state_dict equal to ``utils/convert`` of the same params."""
    dino, sam = states
    if kind == "sam":
        params = jconvert.convert_sam({k: v.numpy() for k, v in sam.items()})
        want = convert.sam_state_dict(params, VIT_T_GLOBAL)
    else:
        params = {"encoder": jconvert.convert_dinov2(
            {k: v.numpy() for k, v in dino.items()})}
        want = convert.fewshot_state_dict(params)
    jcheckpoint.save_params(str(tmp_path / "ck"), params)
    _assert_same(checkpoint.load_params(str(tmp_path / "ck")), want)


def test_orbax_manager_step_loads_its_params(tmp_path, states):
    """A step of JAX's ``CheckpointManager`` (the trainer's state: params,
    optimizer state, step) loads the newest step's params."""
    import optax

    from protosam_tpu.train.step import TrainState

    dino, _ = states
    params = {"encoder": jconvert.convert_dinov2(
        {k: v.numpy() for k, v in dino.items()})}
    old = {"encoder": {k: v for k, v in params["encoder"].items()}}
    old["encoder"]["norm"] = {k: v * 0 for k, v in
                              params["encoder"]["norm"].items()}
    opt = optax.sgd(0.1, momentum=0.9)
    mngr = jcheckpoint.CheckpointManager(str(tmp_path / "snaps"))
    for step, p in ((2, old), (4, params)):
        mngr.save(step, TrainState(p, opt.init(p), np.int32(step)))
    mngr.wait()
    _assert_same(checkpoint.load_params(str(tmp_path / "snaps")),
                 convert.fewshot_state_dict(params))
    tree = checkpoint.read_orbax(str(tmp_path / "snaps" / "2" / "default"))
    assert int(tree["step"]) == 2 and set(tree) == {"params", "opt_state",
                                                    "step"}


def test_orbax_without_tensorstore_names_the_package(tmp_path, states,
                                                     monkeypatch):
    dino, _ = states
    params = {"encoder": jconvert.convert_dinov2(
        {k: v.numpy() for k, v in dino.items()})}
    jcheckpoint.save_params(str(tmp_path / "ck"), params)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        checkpoint.load_params(str(tmp_path / "ck"))


def test_strict_load_names_missing_and_unexpected_keys(states, monkeypatch):
    _, sam = states
    bad = dict(sam)
    bad.pop("mask_decoder.iou_token.weight")
    bad["image_encoder.extra.weight"] = torch.zeros(1)
    monkeypatch.setattr(protosam_eval, "SAM_IMAGE_SIZE", 256)
    with pytest.raises(RuntimeError) as err:
        protosam_eval.build_models(_cfg(), device="cpu", sam_state=bad)
    assert "mask_decoder.iou_token.weight" in str(err.value)
    assert "image_encoder.extra.weight" in str(err.value)


@pytest.mark.parametrize("manifest,build", [
    ("sam_vit_h_keys", lambda: build_sam("vit_h")),
    ("dinov2_vitl14_hub_keys", lambda: build_dinov2("dinov2_vitl14"))],
    ids=["sam-vit-h", "dinov2-vitl14"])
def test_full_size_modules_have_the_reference_keys(manifest, build):
    want = json.loads((MANIFESTS / f"{manifest}.json").read_text())
    with torch.device("meta"):
        module = build()
    got = {k: list(v.shape) for k, v in module.state_dict().items()}
    assert got == want


# ---------------------------------------------------------- build_models


def _cfg(**kw):
    return Config(modelname="dinov2_t14", input_size=(126, 126),
                  protosam_sam_ver="vit_t", dtype="float32", do_cca=True,
                  max_ccs=4, seed=3, **kw)


def _masks(pipe):
    g = torch.Generator().manual_seed(0)
    vol = resize_bilinear(torch.randn(2, 3, 21, 21, generator=g),
                          (126, 126)) * 3.0
    fg = torch.zeros(1, 126, 126)
    fg[:, 42:84, 42:84] = 1.0
    return pipe.forward_volume(vol, ALPNetInput(vol[:1], fg, vol[:1]),
                               slice_batch=2)


@pytest.mark.parametrize("sam_ver", ["vit_t", "medsam"])
def test_build_models_loads_snapshots(tmp_path, monkeypatch, sam_ver):
    """``reload_model_path`` and ``sam_state`` from ``.pth`` files give the
    masks of the same weights built in memory, and not those of the
    seeded build."""
    monkeypatch.setattr(protosam_eval, "SAM_IMAGE_SIZE", 256)
    if sam_ver == "medsam":  # MedSAM is SAM ViT-B: keep it narrow here
        monkeypatch.setitem(protosam_eval.SAM_VERSIONS, "medsam", "vit_t")
    coarse = seeded_state_dict(FewShotSeg(image_size=126,
                                          which_model="dinov2_t14"), 7)
    sam = seeded_state_dict(build_sam("vit_t", image_size=256), 8)
    torch.save(coarse, tmp_path / "alpnet.pth")
    torch.save(sam, tmp_path / "sam.pth")

    cfg = _cfg(reload_model_path=str(tmp_path / "alpnet.pth"))
    cfg.protosam_sam_ver = sam_ver
    loaded = protosam_eval.build_models(
        cfg, device="cpu", sam_state=convert.load_sam_pth(
            str(tmp_path / "sam.pth")))
    cfg.reload_model_path = None
    memory = protosam_eval.build_models(cfg, device="cpu",
                                        coarse_state=coarse, sam_state=sam)
    seeded = protosam_eval.build_models(cfg, device="cpu")
    assert type(loaded) is type(memory)
    assert isinstance(loaded, ProtoMedSAM) == (sam_ver == "medsam")
    (p, s), (mp, ms) = _masks(loaded), _masks(memory)
    torch.testing.assert_close(p, mp, atol=0, rtol=0)
    torch.testing.assert_close(s, ms, atol=0, rtol=0)
    assert 0.0 < float(p.mean()) < 1.0
    for a, b in ((loaded.coarse_model.encoder.pos_embed,
                  seeded.coarse_model.encoder.pos_embed),
                 (loaded.sam_model.image_encoder.pos_embed,
                  seeded.sam_model.image_encoder.pos_embed)):
        assert not torch.equal(a, b)  # the files' weights, not the seed's


def test_build_models_refuses_a_sam_snapshot_as_the_coarse_model(tmp_path,
                                                                 states):
    _, sam = states
    torch.save(sam, tmp_path / "sam.pth")
    with pytest.raises(RuntimeError, match="image_encoder.pos_embed"):
        protosam_eval.build_models(
            _cfg(reload_model_path=str(tmp_path / "sam.pth")), device="cpu")


def test_build_models_medsam_matches_jax():
    """``protosam_sam_ver="medsam"``: a ``ProtoMedSAM`` on SAM ViT-B with
    JAX's ``ProtoSAMConfig``."""
    over = dict(modelname="dinov2_t14", input_size=(126, 126),
                protosam_sam_ver="medsam", do_cca=True, max_ccs=4,
                use_points=True, point_mode="conf")
    pipe = protosam_eval.build_models(Config(**over), device="cpu")
    jpipe = jeval.build_models(JConfig(**over), coarse_params={},
                               sam_params={})
    assert isinstance(pipe, ProtoMedSAM)
    assert type(jpipe).__name__ == "ProtoMedSAM"
    assert dataclasses.asdict(pipe.config) == dataclasses.asdict(
        jpipe.config)
    enc = pipe.sam_model.image_encoder
    assert (len(enc.blocks), enc.pos_embed.shape[-1]) == (
        jpipe.sam_model.encoder_depth, jpipe.sam_model.encoder_embed_dim)
