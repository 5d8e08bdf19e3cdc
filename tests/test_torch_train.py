"""Parity of the port's training path with the JAX package on the CPU
(f32 unless stated, tiny sizes): K1 and K2 under autograd against
``jax.vjp`` of JAX's custom-VJP kernels, the plain ALP path's gradient,
the losses, the train step with SGD / AdamW / accumulation, the
non-finite skip, the ResNet-101 encoder, LoRA, and the f32 master weights
of a bf16 training build.  Kernel-only checks are marked ``cuda``."""

import numpy as np
import pytest
import torch

try:  # the JAX reference; the GPU machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp
    import optax

    from protosam_tpu.models.alpnet.fewshot import FewShotSeg as JFewShotSeg
    from protosam_tpu.models.backbones.resnet import \
        DeeplabRes101Encoder as JResNet
    from protosam_tpu.ops import alp as jalp
    from protosam_tpu.ops import attention as jattn
    from protosam_tpu.ops import norm as jnorm
    from protosam_tpu.train import lora as jlora
    from protosam_tpu.train import step as jstep
    from protosam_tpu.utils.torch_convert import convert_deeplab_resnet101
except ImportError:
    pass

from torch_parity import jax_coarse_params, seeded_state_dict

from protosam_tpu_torch.entry import set_f32_precision
from protosam_tpu_torch.models.alpnet.fewshot import FewShotSeg
from protosam_tpu_torch.models.backbones.resnet import DeeplabRes101Encoder
from protosam_tpu_torch.ops import alp as talp
from protosam_tpu_torch.ops import attention as tattn
from protosam_tpu_torch.ops import norm as tnorm
from protosam_tpu_torch.train import lora
from protosam_tpu_torch.train import step as tstep
from protosam_tpu_torch.train.trainer import build_coarse_model
from protosam_tpu_torch.utils.config import Config
from protosam_tpu_torch.utils.convert import resnet_state_dict
from protosam_tpu_torch.utils.synthetic import synthetic_state_dict

torch.set_num_threads(2)
HW = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels run only there")
    set_f32_precision()
    return torch.device("cuda")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, dtype):
    """f32 1e-5 (absolute); bf16 2e-2·max(1, max|ref|)."""
    got = np.asarray(torch.as_tensor(got).float().detach())
    want = np.asarray(want, dtype=np.float32)
    tol = 1e-5 if dtype == "f32" else 2e-2 * max(1.0, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


DTYPES = {"f32": (torch.float32, np.float32),
          "bf16": (torch.bfloat16, "bfloat16")}


# ------------------------------------------------- K1 / K2 under autograd


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 17, 64), (40, 160)])
def test_layer_norm_grad_matches_jax_vjp(shape, kind):
    tdt, jdt = DTYPES[kind]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    want, vjp = jax.vjp(lambda a, s, o: jnorm.layer_norm_tokens(a, s, o),
                        jx, jnp.asarray(w), jnp.asarray(b))
    wants = vjp(jnp.asarray(g).astype(jdt))

    xt = t(x).to(tdt).requires_grad_()
    wt, bt = t(w).requires_grad_(), t(b).requires_grad_()
    before = tnorm.layer_norm_rows.backward_calls
    y = tnorm.layer_norm_tokens(xt, wt, bt)
    grads = torch.autograd.grad(y, (xt, wt, bt), t(g).to(tdt))
    assert tnorm.layer_norm_rows.backward_calls == before + 1
    assert grads[0].dtype == tdt and grads[1].dtype == torch.float32
    for got, ref in zip((y, *grads), (want, *wants)):
        close(got, np.asarray(ref, np.float32), kind)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("nh,hd,s,n_valid", [(2, 32, 40, None),
                                             (2, 16, 48, 41)])
def test_packed_attention_grad_matches_jax_vjp(nh, hd, s, n_valid, kind):
    tdt, jdt = DTYPES[kind]
    rng = np.random.default_rng(1)
    qkv = rng.standard_normal((2, s, 3 * nh * hd)).astype(np.float32)
    g = rng.standard_normal((2, s, nh * hd)).astype(np.float32)
    kw = dict(scale=hd ** -0.5, num_heads=nh, n_valid=n_valid)
    want, vjp = jax.vjp(lambda a: jattn.masked_flash_attention_packed(
        a, interpret=True, **kw), jnp.asarray(qkv).astype(jdt))
    (gwant,) = vjp(jnp.asarray(g).astype(jdt))

    x = t(qkv).to(tdt).requires_grad_()
    before = tattn.masked_flash_attention_packed.backward_calls
    out = tattn.masked_flash_attention_packed(x, **kw)
    (gx,) = torch.autograd.grad(out, x, t(g).to(tdt))
    assert tattn.masked_flash_attention_packed.backward_calls == before + 1
    assert gx.dtype == tdt
    close(out, np.asarray(want, np.float32), kind)
    close(gx, np.asarray(gwant, np.float32), kind)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_k2_backward_is_autograd_of_the_head_math(kind):
    """The hand-written per-head VJP gives what autograd of the per-head
    plain math gives."""
    tdt = DTYPES[kind][0]
    g = torch.Generator().manual_seed(5)
    q, k, v, gy = (torch.randn(2, 60, 32, generator=g).to(tdt)
                   for _ in range(4))
    for n_valid in (None, 50):
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        o = tattn.packed_attention_head_math(*ins, 0.17, n_valid)
        want = torch.autograd.grad(o, ins, gy)
        got = tattn.packed_attention_head_vjp(q, k, v, gy, 0.17, n_valid)
        for a, e in zip(got, want):
            assert a.dtype == e.dtype
            assert (a.float() - e.float()).abs().max() <= \
                1e-6 * e.float().abs().max()


def test_bf16_score_variant_and_fused_alp_refuse_grad():
    qkv = torch.randn(1, 8, 48, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.masked_flash_attention_packed(qkv, scale=0.25, num_heads=2,
                                            score_dtype=torch.bfloat16)
    q = torch.randn(1, 8, 4, 4, requires_grad=True)
    protos = torch.randn(3, 8)
    valid = torch.ones(3, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="no backward"):
        talp.alp_match_fused(q, protos, valid)
    with pytest.raises(RuntimeError, match="no backward"):
        talp.score_prototypes(q, talp.Prototypes(protos, valid),
                              use_fused=True)
    with torch.no_grad():  # inference keeps K5
        assert talp.alp_match_fused(q, protos, valid).shape == (1, 1, 4, 4)


@pytest.mark.parametrize("mode", ["gridconv", "gridconv+", "mask"])
def test_plain_alp_grad_matches_jax(mode):
    rng = np.random.default_rng(2)
    qry = rng.standard_normal((1, 16, 8, 8)).astype(np.float32)
    sup = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    msk = (rng.random((2, 1, 8, 8)) > 0.4).astype(np.float32)
    g = rng.standard_normal((1, 1, 8, 8)).astype(np.float32)

    def jf(q, s):
        return jalp.alp_score(q, s, jnp.asarray(msk), mode, 2, 0.5)

    want, vjp = jax.vjp(jf, jnp.asarray(qry), jnp.asarray(sup))
    wq, ws = vjp(jnp.asarray(g))
    q, s = t(qry).requires_grad_(), t(sup).requires_grad_()
    out = talp.alp_score(q, s, t(msk), mode, 2, 0.5)
    gq, gs = torch.autograd.grad(out, (q, s), t(g))
    for got, ref in ((out, want), (gq, wq), (gs, ws)):
        close(got, np.asarray(ref), "f32")


# ------------------------------------------------------------- the losses


@pytest.fixture(scope="module")
def tiny():
    """The tiny coarse model's seeded weights, as the port's state_dict
    and as JAX params, and the JAX module."""
    sd = seeded_state_dict(FewShotSeg(image_size=HW,
                                      which_model="dinov2_t14"), 3)
    return sd, jax_coarse_params(sd), JFewShotSeg(image_size=HW,
                                                  which_model="dinov2_t14")


def episode(seed, batch=1):
    rng = np.random.default_rng(seed)
    fg = np.zeros((batch, 1, HW, HW), np.float32)
    fg[..., 20:44, 16:40] = 1
    lbl = np.zeros((batch, HW, HW), np.int32)
    lbl[:, 24:40, 20:46] = 1
    lbl[:, :3] = 255
    return (rng.standard_normal((batch, 1, 3, HW, HW)).astype(np.float32),
            fg, 1 - fg,
            rng.standard_normal((batch, 1, 3, HW, HW)).astype(np.float32),
            lbl)


def test_weighted_ce_matches_jax():
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((2, 2, 16, 16))).astype(np.float32)
    labels = rng.integers(0, 2, (2, 16, 16)).astype(np.int32)
    labels[0, :4] = 255
    want = float(jstep.weighted_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tstep.weighted_ce(t(logits), t(labels)))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
    # torch's own weighted mean (ignore_index 255) is what JAX replicates
    ref = torch.nn.functional.cross_entropy(
        t(logits), t(labels).long(), weight=torch.tensor([0.05, 1.0]),
        ignore_index=255)
    assert abs(got - float(ref)) <= 1e-5


def test_align_loss_matches_jax(tiny):
    """The alignment loss on the same features, scores and masks (the
    train step tests hold the whole episode's loss)."""
    sd, params, jm = tiny
    supp, fg, bg, qry, _ = episode(5)
    model = build_coarse_model(Config(modelname="dinov2_t14",
                                      input_size=(HW, HW), dtype="float32"),
                               "cpu", sd)
    with torch.no_grad():
        out = model(t(supp[0]), t(fg[0]), t(bg[0]), t(qry[0]), isval=False)
    feats = [out[k].numpy() for k in ("qry_fts", "logits", "supp_fts")]
    qf = t(feats[0]).requires_grad_()
    got = model.align_loss(qf, t(feats[1]), t(feats[2]), t(fg[0]),
                           t(bg[0]), model.kernel_size)
    want = jax.jit(lambda *a: jm.apply(
        {"params": params}, *a, jm.kernel_size, method=jm.align_loss))(
        *(jnp.asarray(a) for a in (*feats, fg[0], bg[0])))
    assert abs(float(got) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    torch.autograd.grad(got, qf)  # differentiable in the query features


# --------------------------------------------------------- the train step


def _jax_opt(kind):
    if kind == "adamw":
        return jstep.make_optimizer(optim_type="adamw")
    opt = jstep.make_optimizer(optim_type="sgd")
    return optax.MultiSteps(opt, 2) if kind == "accum2" else opt


def rel_errs(got: dict, want: dict) -> dict:
    return {k: float((got[k] - v).abs().max() / v.abs().max().clamp(
        min=1e-12)) for k, v in want.items()}


def rel_err(got: dict, want: dict) -> float:
    return max(rel_errs(got, want).values())


@pytest.mark.parametrize("kind,calls", [("sgd", 3), ("adamw", 3),
                                        ("accum2", 4)])
def test_train_steps_match_jax(tiny, kind, calls):
    """Every step's loss, ce and align within 1e-5; after the steps, every
    param within 1e-5 relative (per tensor, of its max).  AdamW's params
    are held on shared gradients instead (``test_adamw_matches_optax``):
    Adam scales each gradient entry to about ±1, so entries whose gradient
    is rounding noise, such as the qkv key bias (softmax ignores a shift
    of every key, so its gradient is 0 in exact arithmetic), move by up to
    ±lr apart in any two implementations."""
    from protosam_tpu_torch.utils.convert import fewshot_state_dict

    sd, params, jm = tiny
    opt = _jax_opt(kind)
    step = jax.jit(jstep.make_train_step(jm, opt))
    state = jstep.TrainState(params, opt.init(params),
                             jnp.zeros((), jnp.int32))
    model = build_coarse_model(Config(modelname="dinov2_t14",
                                      input_size=(HW, HW), dtype="float32"),
                               "cpu", sd)
    topt = tstep.make_optimizer(
        model.parameters(), optim_type="adamw" if kind == "adamw" else "sgd",
        accumulate=2 if kind == "accum2" else 1)
    for i in range(calls):
        arrays = episode(10 + i)
        state, jm_ = step(state, tuple(jnp.asarray(a) for a in arrays))
        tm = tstep.train_step(model, topt,
                              tstep.Batch.from_numpy(arrays, "cpu"))
        for k in ("loss", "ce", "align_loss"):
            want = float(jm_[k])
            assert abs(float(tm[k]) - want) <= 1e-5 * max(1, abs(want))
    want = fewshot_state_dict(jax.tree.map(np.asarray, state.params))
    del want["encoder.mask_token"]  # no JAX leaf: zeros in the converter
    got = {k: v for k, v in model.state_dict().items() if k in want}
    if kind != "adamw":
        assert rel_err(got, want) <= 1e-5
    assert rel_err(got, {k: sd[k] for k in want}) > 1e-4  # they moved


@pytest.mark.parametrize("accumulate", [1, 2])
def test_adamw_matches_optax(accumulate):
    """The port's AdamW (and its accumulation) against optax's on the same
    params and gradients, gradients from tiny to large and one all zero:
    every param within 1e-5 relative after 3 updates."""
    rng = np.random.default_rng(11)
    shapes = [(64, 32), (32,), (5, 7, 3), (16,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    opt = jstep.make_optimizer(optim_type="adamw")
    if accumulate > 1:
        opt = optax.MultiSteps(opt, accumulate)
    jp = [jnp.asarray(p) for p in p0]
    state = opt.init(jp)
    tp = [t(p.copy()) for p in p0]
    topt = tstep.make_optimizer(tp, optim_type="adamw",
                                accumulate=accumulate)
    for i in range(3 * accumulate):
        grads = [(rng.standard_normal(s) * 10.0 ** rng.integers(-9, 1, s))
                 .astype(np.float32) for s in shapes]
        grads[-1][:] = 0
        upd, state = opt.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step([t(g) for g in grads])
    for a, b in zip(tp, jp):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_skipped_update_leaves_params():
    model = build_coarse_model(Config(modelname="dinov2_t14",
                                      input_size=(HW, HW), dtype="float32"),
                               "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    arrays = list(episode(6))
    arrays[3] = arrays[3] * np.float32(np.nan)
    opt = tstep.make_optimizer(model.parameters())
    m = tstep.train_step(model, opt, tstep.Batch.from_numpy(arrays, "cpu"),
                         apply_update=lambda m: bool(torch.isfinite(
                             m["loss"])))
    assert not torch.isfinite(m["loss"])
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in before.items())
    assert opt.count == 0


# ---------------------------------------------------- f32 master weights


def test_bf16_training_build_keeps_f32_master_weights():
    cfg = Config(modelname="dinov2_t14", input_size=(HW, HW),
                 dtype="bfloat16")
    model = build_coarse_model(cfg, "cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    ref = synthetic_state_dict(model, cfg.seed)
    assert all(torch.equal(ref[k], v) for k, v in model.state_dict().items())
    arrays = episode(7)
    m = tstep.train_step(model, tstep.make_optimizer(model.parameters()),
                         tstep.Batch.from_numpy(arrays, "cpu"))
    assert torch.isfinite(m["loss"])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    w = model.encoder.blocks[0].attn.qkv.weight
    # an f32 step moves weights by less than a bf16 ulp: kept, not rounded
    assert not torch.equal(w, w.to(torch.bfloat16).float())


def test_master_weight_forward_matches_the_inference_build():
    """Cast at use gives the rounded-params forward bit for bit where the
    two builds hold the same values (all but the pos-embed, which the
    inference build rounds before its f32 resize)."""
    from protosam_tpu_torch.models.dinov2.vit import build_dinov2
    from protosam_tpu_torch.models.layers import cast_compute

    torch.manual_seed(0)
    a, b = build_dinov2("dinov2_vitt14"), build_dinov2("dinov2_vitt14")
    sd = synthetic_state_dict(a, 1)
    sd["pos_embed"] = sd["pos_embed"].to(torch.bfloat16).float()
    a.load_state_dict(sd)
    b.load_state_dict(sd)
    cast_compute(a, torch.bfloat16)
    cast_compute(b, torch.bfloat16, master_weights=True)
    x = torch.randn(2, 3, 56, 56)
    with torch.no_grad():
        ya, yb = a(x), b(x)
    assert torch.equal(ya["x_norm_patchtokens"], yb["x_norm_patchtokens"])


# -------------------------------------------------------------- ResNet-101


def test_resnet101_features_match_jax():
    enc = DeeplabRes101Encoder()
    sd = synthetic_state_dict(enc, 2)
    enc.load_state_dict(sd)
    params = convert_deeplab_resnet101({k: v.numpy() for k, v in sd.items()})
    back = resnet_state_dict(params)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    x = np.random.default_rng(3).standard_normal((1, 3, HW, HW)).astype(
        np.float32)
    want = np.asarray(JResNet().apply({"params": params},
                                      jnp.asarray(x.transpose(0, 2, 3, 1))))
    with torch.no_grad():
        got = enc(t(x)).numpy().transpose(0, 2, 3, 1)
    assert want.shape == (1, 8, 8, 256)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_resnet_fewshot_and_snapshot_layout(tmp_path):
    from protosam_tpu_torch.utils.checkpoint import load_params

    model = FewShotSeg(image_size=HW, which_model="dlfcn_res101")
    assert model.feature_hw == 8 and model.kernel_size == 1
    sd = {k: v for k, v in model.state_dict().items()}
    ref = dict(sd, **{"encoder.backbone.bn1.num_batches_tracked":
                      torch.tensor(0)})
    torch.save(ref, tmp_path / "alpnet_res101.pth")
    model.load_state_dict(load_params(str(tmp_path / "alpnet_res101.pth")))


# -------------------------------------------------------------------- LoRA


def test_lora_files_pass_both_ways_and_merge(tiny, tmp_path):
    sd, params, _ = tiny
    ours = lora.init_lora(sd, rank=2, seed=1)
    theirs = jlora.init_lora(params, rank=2, key=jax.random.PRNGKey(1))
    assert ours["factors"].keys() == theirs["factors"].keys()
    for name, f in theirs["factors"].items():
        for part in ("a", "b"):
            assert tuple(ours["factors"][name][part].shape) == f[part].shape
    # merge at init is the identity
    merged = lora.merge_lora(sd, ours)
    assert all(torch.equal(merged[k], v) for k, v in sd.items())

    ours["factors"] = {n: {p: v + 0.01 * (i + 1) for i, (p, v) in
                           enumerate(f.items())}
                       for n, f in ours["factors"].items()}
    lora.save_lora(str(tmp_path / "port.safetensors"), ours)
    back = jlora.load_lora(str(tmp_path / "port.safetensors"))
    assert (back["scale"], back["rank"]) == (1.0, 2)
    for name, f in ours["factors"].items():
        for part in ("a", "b"):
            assert np.array_equal(np.asarray(back["factors"][name][part]),
                                  f[part].numpy())
    jlora.save_lora(str(tmp_path / "jax.safetensors"), back)
    again = lora.load_lora(str(tmp_path / "jax.safetensors"))
    for name, f in ours["factors"].items():
        for part in ("a", "b"):
            assert torch.equal(again["factors"][name][part], f[part])

    from protosam_tpu_torch.utils.convert import fewshot_state_dict

    jmerged = fewshot_state_dict(jax.tree.map(
        np.asarray, jlora.merge_lora(params, back)))
    tmerged = lora.collapse_lora(sd, ours)
    del jmerged["encoder.mask_token"]  # no JAX leaf: zeros in the converter
    for k, v in jmerged.items():
        assert torch.allclose(tmerged[k], v, atol=1e-6, rtol=0), k


def test_lora_only_step_leaves_base_weights(tiny):
    sd, _, _ = tiny
    model = build_coarse_model(Config(modelname="dinov2_t14",
                                      input_size=(HW, HW), dtype="float32"),
                               "cpu", sd)
    model.requires_grad_(False)
    factors = lora.init_lora(model.state_dict(), rank=2, seed=0)
    params = lora.lora_parameters(factors)
    opt = tstep.make_optimizer(params, lr=1e-2)
    b0 = {n: f["b"].clone() for n, f in factors["factors"].items()}
    arrays = episode(8)

    def loss_fn(m, batch):
        loss, ce, align = tstep.episode_loss(
            m, batch.supp[0], batch.fg[0], batch.bg[0], batch.qry[0],
            batch.lbl[0], 1.0, 2)
        return loss, {"ce": ce, "align_loss": align}

    for _ in range(2):
        loss, aux = lora.lora_train_step(
            model, factors, opt, loss_fn,
            tstep.Batch.from_numpy(arrays, "cpu"))
        assert torch.isfinite(loss)
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
    assert any(not torch.equal(f["b"], b0[n])
               for n, f in factors["factors"].items())


# ------------------------------------------------------- CUDA kernels


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_kernels_under_grad_match_plain_autograd(cuda, kind):
    """K1 and K2 launch forward and run their plain VJP backward on the
    card; against the plain versions' autograd in f32."""
    tdt = DTYPES[kind][0]
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)
    x, w, b, gy = r(300, 1024) * 3 + 1, 1 + 0.1 * r(1024), 0.1 * r(1024), \
        r(300, 1024)
    xk = x.to(tdt).requires_grad_()
    wk, bk = w.clone().requires_grad_(), b.clone().requires_grad_()
    launches = tnorm.layer_norm_rows.launches
    y = tnorm.layer_norm_rows(xk, wk, bk)
    got = (y, *torch.autograd.grad(y, (xk, wk, bk), gy.to(tdt)))
    assert tnorm.layer_norm_rows.launches == launches + 1
    xr = xk.detach().float().requires_grad_()
    yr = tnorm.layer_norm_rows_plain(xr, wk, bk, 1e-6, torch.float32)
    want = (yr, *torch.autograd.grad(yr, (xr, wk, bk), gy.to(tdt).float()))
    for a, e in zip(got, want):
        tol = 1e-4 if kind == "f32" else 2e-2 * max(1, e.abs().max().item())
        assert (a.float() - e).abs().max().item() <= tol

    qkv = (r(2, 300, 3 * 4 * 64)).to(tdt).requires_grad_()
    gout = r(2, 300, 4 * 64).to(tdt)
    launches = tattn.masked_flash_attention_packed.launches
    o = tattn.masked_flash_attention_packed(qkv, scale=0.125, num_heads=4,
                                            n_valid=280)
    (gq,) = torch.autograd.grad(o, qkv, gout)
    assert tattn.masked_flash_attention_packed.launches == launches + 1
    ref = qkv.detach().float().requires_grad_()
    orr = tattn.masked_attention_packed_plain(ref, scale=0.125, num_heads=4,
                                              n_valid=280)
    (gr,) = torch.autograd.grad(orr, ref, gout.float())
    for a, e in ((o, orr), (gq, gr)):
        tol = 1e-4 if kind == "f32" else 2e-2 * max(1, e.abs().max().item())
        assert (a.float() - e).abs().max().item() <= tol
