"""Parity of the modules under the port's FasterRCNN with the JAX package on
the CPU, in float32 unless stated: the box coder and ``box_ioa_matrix``,
the RPN anchors, RoIAlign/RoIPool, ResNet, the backbone registry,
CSPDarknet's C2 tap, the FPN and PAFPNv8 necks, and YOLOv5 over a registry
backbone.

Each network's flax variables are drawn from a numpy seed over the shapes
of ``jax.eval_shape`` (``torch_rcnn_refs.draw_variables``) and carried to
the port by ``from_jax_variables`` with ``strict=True``. Tolerances: the
anchors, ``_roi_levels`` and the registry exactly; the coder and
``box_ioa_matrix`` within 1e-5 relative (a log, an exp and a division in
float32); network outputs within 1e-5 of their largest magnitude (float32
convs summed in another order); RoIAlign within 1e-5 of the largest
feature in float32 (the port sums a bin's 16 weighted taps in one batched
matmul; the reference's jitted program contracts its tap weights into
multiply-adds, and differs from its own eager run by as much) and, with
bfloat16 features, within 2⁻⁷ of it (the reference rounds tap products
and partial sums to bfloat16, the port's matmul accumulates in float32 and
rounds once); RoIPool exactly (a max of gathered values).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heltondetection_tpu.models import backbones as JB
from heltondetection_tpu.models.cspdarknet import CSPDarknet as JCSP
from heltondetection_tpu.models.necks import FPN as JFPN
from heltondetection_tpu.models.necks import PAFPNv8 as JPAFPNv8
from heltondetection_tpu.models.resnet import RESNET_STAGES, ResNet as JResNet
from heltondetection_tpu.models.yolov5 import YOLOv5 as JYOLOv5
from heltondetection_tpu.models import faster_rcnn as JR
from heltondetection_tpu.ops import anchors as JA
from heltondetection_tpu.ops import boxes as JBX
from heltondetection_tpu.ops import roi_align as JRA

from heltondetection_tpu_torch.configs import base as p_base
from heltondetection_tpu_torch.engine import runner
from heltondetection_tpu_torch.models import backbones as PB
from heltondetection_tpu_torch.models import faster_rcnn as PR
from heltondetection_tpu_torch.models.common import init_weights
from heltondetection_tpu_torch.models.cspdarknet import CSPDarknet
from heltondetection_tpu_torch.models.necks import FPN, PAFPNv8
from heltondetection_tpu_torch.models.resnet import ResNet
from heltondetection_tpu_torch.models.yolov5 import YOLOv5
from heltondetection_tpu_torch.ops import anchors as PA
from heltondetection_tpu_torch.ops import boxes as PBX
from heltondetection_tpu_torch.ops import roi_align as PRA
from heltondetection_tpu_torch.utils.ckpt import save_eval_variables

from torch_rcnn_refs import draw_variables, load_port

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rel=1e-5):
    """got (torch, NCHW when 4-D) against want (flax, NHWC)."""
    got = got.detach()
    if got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _boxes(rng, n, size=200.0):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(1, size * 0.5, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# box coder, ioa, anchors
# ---------------------------------------------------------------------------

def test_delta_coder_and_ioa_match_jax():
    """encode and decode with both weight sets (the RPN's and the box
    head's), dw/dh past the log(1000/16) clamp, zero-width targets, and
    box_ioa_matrix."""
    rng = np.random.default_rng(0)
    anchors, gt = _boxes(rng, 300), _boxes(rng, 300)
    gt[:5, 2] = gt[:5, 0]                       # zero width: log of EPS
    deltas = rng.normal(0, 2, (300, 4)).astype(np.float32)
    deltas[:20, 2:] = rng.uniform(4.2, 9.0, (20, 2))    # past the clamp
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        np.testing.assert_allclose(
            PBX.encode_deltas(torch.from_numpy(anchors), torch.from_numpy(gt),
                              w).numpy(),
            np.asarray(JBX.encode_deltas(anchors, gt, w)), rtol=1e-5,
            atol=1e-5)
        d = deltas * np.float32(w[0]) if w[0] > 1 else deltas
        np.testing.assert_allclose(
            PBX.decode_deltas(torch.from_numpy(anchors), torch.from_numpy(d),
                              w).numpy(),
            np.asarray(JBX.decode_deltas(anchors, d, w)), rtol=1e-5,
            atol=1e-3)
    a, b = _boxes(rng, 40), _boxes(rng, 70)
    np.testing.assert_allclose(
        PBX.box_ioa_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(JBX.box_ioa_matrix(a, b)), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("size", [640, 832, 1280])
def test_rpn_pyramid_anchors_match_jax(size):
    """The RPN anchors of every level, bit for bit and in (h, w, a) order;
    FasterRCNN's cached pyramid too."""
    got, counts = PA.rpn_pyramid_anchors(size)
    want, want_counts = JA.rpn_pyramid_anchors(size)
    assert counts == want_counts
    np.testing.assert_array_equal(got, np.asarray(want))
    pa, pc = PR.pyramid_anchors(size)
    ja, jc = JR.pyramid_anchors(size)
    assert pc == jc
    np.testing.assert_array_equal(pa, ja)
    if size == 832:
        assert counts == (129792, 32448, 8112, 2028, 507)
    np.testing.assert_array_equal(
        PA.rpn_level_anchors(3, 5, 16, (64, 90), (0.5, 2.0)),
        JA.rpn_level_anchors(3, 5, 16, (64, 90), (0.5, 2.0)))
    for lvl in range(3):
        np.testing.assert_array_equal(PA.yolo_level_anchors(lvl).numpy(),
                                      np.asarray(JA.yolo_level_anchors(lvl)))


def test_roi_levels_match_jax():
    """torchvision's level map, exactly, over rois from 0 px to the image."""
    rng = np.random.default_rng(1)
    rois = _boxes(rng, 2000, size=1300.0)
    rois[:10, 2:] = rois[:10, :2]                       # empty rois
    for levels in (1, 4):
        got = PRA._roi_levels(torch.from_numpy(rois), levels, 2, 224.0)
        want = JRA._roi_levels(jnp.asarray(rois), levels, 2, 224.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) == 4


# ---------------------------------------------------------------------------
# RoIAlign / RoIPool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_ops_match_jax(dtype):
    """roi_align and roi_pool over one map, and multilevel_roi_align (align
    and pool) over a batch of two images and four levels, against the
    reference's per-image functions: rois of every level, rois reaching
    past the map's edge, and tiny rois."""
    rng = np.random.default_rng(2)
    strides = (4, 8, 16, 32)
    size, c, b, r = 256, 16, 2, 60
    feats = [rng.normal(0, 1, (b, size // s, size // s, c)).astype(np.float32)
             for s in strides]
    rois = np.stack([_boxes(rng, r, size=300.0) for _ in range(b)])
    rois[:, :4] = [[-20, -10, 40, 30], [230, 240, 290, 300],
                   [100, 100, 100.5, 100.5], [0, 0, 256, 256]]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    top = max(float(np.abs(f).max()) for f in feats)
    tol = top * (2.0 ** -7 if dtype == "bfloat16" else 1e-5)
    jfeats = [jnp.asarray(f).astype(jdt) for f in feats]
    tfeats = [torch.from_numpy(f).to(tdt) for f in feats]

    def close(got, want, atol):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=atol)

    # one map: P3 of image 0, stride 8
    close(PRA.roi_align(tfeats[1][0], torch.from_numpy(rois[0]),
                        spatial_scale=1 / 8),
          jax.jit(lambda f, r: JRA.roi_align(f, r, spatial_scale=1 / 8))(
              jfeats[1][0], rois[0]), tol)
    close(PRA.roi_pool(tfeats[1][0], torch.from_numpy(rois[0]),
                       spatial_scale=1 / 8),
          jax.jit(lambda f, r: JRA.roi_pool(f, r, spatial_scale=1 / 8))(
              jfeats[1][0], rois[0]), 0.0)
    for method in ("align", "pool"):
        got = PRA.multilevel_roi_align(tfeats, torch.from_numpy(rois),
                                       strides, method=method)
        assert got.dtype == tdt and got.shape == (b, r, 7, 7, c)
        # per image, batched the way the reference's box head batches it
        want = jax.jit(jax.vmap(lambda fs, rs: JRA.multilevel_roi_align(
            list(fs), rs, strides, method=method)))(jfeats, rois)
        assert want.dtype == jdt
        close(got, want, tol if method == "align" else 0.0)
    # a roi past the map's last row and column reads the clamped taps:
    # the reference's rolled copies meet a weight of exactly 0 there
    edge = torch.tensor([[[250.0, 250.0, 300.0, 300.0]]])
    one = [t[:1] for t in tfeats]
    assert torch.isfinite(PRA.multilevel_roi_align(one, edge, strides)).all()


# ---------------------------------------------------------------------------
# backbones and necks
# ---------------------------------------------------------------------------

def _flax(module, x, seed, *args, **kw):
    """A flax module's seeded variables and its jitted output on x."""
    shapes = jax.eval_shape(lambda k, x: module.init(k, x, *args, **kw), KEY,
                            x)
    variables = draw_variables(shapes, seed)
    return variables, jax.jit(lambda v, x: module.apply(v, x, *args,
                                                        **kw))(variables, x)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_matches_jax(name):
    """C2..C5 of ResNet at 64², eval mode (BatchNorm eps 1e-5 on running
    statistics, the stem's 3x3/2 max-pool with pad 1), and the registry's
    resnet builds the same module."""
    stages, block = RESNET_STAGES[name]
    x = jnp.asarray(np.random.default_rng(3).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    variables, want = _flax(JResNet(stage_sizes=stages, block=block), x, 4,
                            train=False)
    model = load_port(PB.build_backbone(name), variables)
    assert isinstance(model, ResNet)
    with torch.no_grad():
        got = model(_nchw(x))
    assert len(got) == 4
    assert model.channels == tuple(w.shape[-1] for w in want)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("neck", ["fpn", "pafpn_v8"])
def test_necks_match_jax(neck):
    """P2..P5 and the 1x1/2 max-pooled P6 from four levels of mixed
    widths (FPN's convs with biases; PAFPNv8's ConvBnAct and C3)."""
    rng = np.random.default_rng(5)
    chans = (16, 24, 32, 40)
    feats = [jnp.asarray(rng.normal(0, 1, (2, 32 // 2 ** i, 32 // 2 ** i, c))
                         .astype(np.float32)) for i, c in enumerate(chans)]
    jm = (JFPN if neck == "fpn" else JPAFPNv8)(32)
    shapes = jax.eval_shape(lambda k, f: jm.init(k, f), KEY, feats)
    variables = draw_variables(shapes, 6)
    want = jax.jit(jm.apply)(variables, feats)
    model = load_port((FPN if neck == "fpn" else PAFPNv8)(chans, 32),
                      variables)
    with torch.no_grad():
        got = model([_nchw(f) for f in feats])
    assert len(got) == len(want) == 5
    assert got[-1].shape[-1] == 2
    for g, w in zip(got, want):
        _close(g, w)


def test_cspdarknet_include_c2_matches_jax():
    """CSPDarknet at width 0.125 with its stride-4 C2 tapped after c3_1."""
    x = jnp.asarray(np.random.default_rng(7).uniform(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    jm = JCSP(depth_multiple=0.33, width_multiple=0.125, include_c2=True)
    variables, want = _flax(jm, x, 8, train=False)
    model = load_port(CSPDarknet(0.33, 0.125, include_c2=True), variables)
    with torch.no_grad():
        got = model(_nchw(x))
    assert len(got) == 4 and got[0].shape[-1] == 16
    assert model.channels == (16, 32, 64, 128)
    for g, w in zip(got, want):
        _close(g, w)


def _tiny_csp(dropblock_p, norm_eval, frozen_stages, remat=False):
    return CSPDarknet(0.33, 0.125, dropblock_p=dropblock_p, remat=remat,
                      include_c2=True)


def _tiny_csp_flax(dtype, dropblock_p, module_name, norm_eval,
                   frozen_stages, remat=False):
    return JCSP(depth_multiple=0.33, width_multiple=0.125, dtype=dtype,
                dropblock_p=dropblock_p, include_c2=True, remat=remat,
                name=module_name)


def test_yolov5_over_registry_backbone_matches_jax(tmp_path):
    """YOLOv5 over a backbone registered under a new name in both
    registries (CSPDarknet at width 0.125 with C2): the raw maps of the
    neck and head over its last three features; ``build_model`` and
    ``load_detector`` take the name from a config."""
    name = "cspdarknet_w0125_test"
    JB.register_backbone(name, _tiny_csp_flax)
    PB.register_backbone(name, _tiny_csp)
    x = jnp.asarray(np.random.default_rng(9).uniform(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    jm = JYOLOv5(num_classes=3, depth_multiple=0.33, width_multiple=0.125,
                 backbone=name)
    variables, want = _flax(jm, x, 10, train=False)
    model = load_port(YOLOv5(3, 0.33, 0.125, backbone=name), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(np.array(x)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())
    # a config's variant sets the neck and head widths; the registry
    # backbone brings its own
    cfg = p_base.ExperimentConfig(
        model=p_base.ModelConfig(variant="n", backbone=name, num_classes=3,
                                 img_size=64),
        data=p_base.DataConfig(class_names=["a", "b", "c"]))
    built = runner.build_model(cfg.model, 3)
    assert built.backbone_name == name and built.width_multiple == 0.25
    init_weights(built, torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "ckpt")
    save_eval_variables(ckpt, built.state_dict(), 1)
    det = runner.load_detector(cfg, ckpt=ckpt, device="cpu",
                               conf_thres=0.001)
    boxes, scores, _ = det.detect_image(
        (np.asarray(x[0]) * 255).astype(np.uint8))
    assert len(scores) > 0 and np.isfinite(boxes).all()


def test_backbone_swap_config_builds_through_the_registry():
    """The published yolov5_l_voc_640_backbone_swap: cspdarknet_l from the
    registry (C2 tapped, the last three features used), with the state
    dict of the v6.1 YOLOv5l, whose names the flax tree maps onto
    (``test_yolov5_over_registry_backbone_matches_jax``); it passes the
    train config check, with the registry's train-mode knobs at their
    defaults."""
    import os
    path = os.path.join(os.path.dirname(runner.__file__), "..", "configs",
                        "yolov5_l_voc_640_backbone_swap.py")
    cfg = p_base.load_config(path)
    model = runner.build_model(cfg.model, 20)
    assert model.backbone_name == "cspdarknet_l"
    assert model.backbone.include_c2
    assert model.backbone.channels == (128, 256, 512, 1024)
    plain = runner.build_model(p_base.ModelConfig(variant="l"), 20)
    assert plain.backbone_name == "cspdarknet"
    want = {k: v.shape for k, v in plain.state_dict().items()}
    assert {k: v.shape for k, v in model.state_dict().items()} == want
    model.load_state_dict(plain.state_dict(), strict=True)
    runner._check_train_config(cfg)
    assert not model.backbone.norm_eval and model.backbone.frozen_stages == 0


def test_backbone_registry_matches_jax():
    """Names, frozen-stage prefixes and the refusals of both registries."""
    assert {n for n in PB.backbone_names() if "test" not in n} == \
        {n for n in JB.backbone_names() if "test" not in n}
    for name in ("resnet18", "resnet50", "cspdarknet_s", "cspdarknet_l"):
        for stages in (0, 1, 2):
            assert PB.frozen_stage_prefixes(name, stages) == \
                JB.frozen_stage_prefixes(name, stages)
    assert PB.frozen_stage_prefixes("not_a_backbone", 1) == ()
    with pytest.raises(ValueError, match="unknown backbone"):
        PB.build_backbone("not_a_backbone")

    def no_remat(dropblock_p, norm_eval, frozen_stages):
        return _tiny_csp(dropblock_p, norm_eval, frozen_stages)

    PB.register_backbone("no_remat_test", no_remat)
    assert isinstance(PB.build_backbone("no_remat_test"), CSPDarknet)
    with pytest.raises(ValueError, match="remat"):
        PB.build_backbone("no_remat_test", remat=True)
    with pytest.raises(ValueError, match="unknown backbone"):
        runner.build_model(p_base.ModelConfig(family="faster_rcnn",
                                              backbone="resnet7"), 4)
    # train-mode knobs: BatchNorm of the frozen stem and first stage, and
    # every one under norm_eval, stays on running statistics
    frozen = PB.build_backbone("resnet18", frozen_stages=1).train()
    assert not frozen.stem_bn.training and not frozen.layer1_0.bn1.training
    assert frozen.layer2_0.bn1.training
    assert not any(m.training for m in PB.build_backbone(
        "resnet18", norm_eval=True).train().modules()
        if isinstance(m, torch.nn.BatchNorm2d))


def test_resnet_train_mode_knobs():
    """ResNet's train-mode knobs act in training only: ``frozen_stages``
    stops the gradient through the stem and the first stages and keeps
    their BatchNorm statistics, ``remat`` checkpoints each block with the
    same outputs, gradients and BatchNorm statistics, and ``dropblock_p``
    drops blocks of C3–C5 only; in eval mode the network is the same
    function whatever they are."""
    torch.manual_seed(0)
    x = torch.rand(2, 3, 32, 32)
    nets = {}
    for name, kw in (("plain", {}), ("remat", {"remat": True}),
                     ("frozen", {"frozen_stages": 1}),
                     ("dropblock", {"dropblock_p": 0.5})):
        net = PB.build_backbone("resnet18", **kw)
        if nets:
            net.load_state_dict(nets["plain"].state_dict())
        nets[name] = net
    init = {k: v.clone() for k, v in nets["plain"].state_dict().items()}
    with torch.no_grad():
        ref = nets["plain"].eval()(x)
        for net in nets.values():
            for a, b in zip(net.eval()(x), ref):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    outs, grads, stats = {}, {}, {}
    for name in ("plain", "remat", "frozen"):
        net = nets[name].train()
        out = net(x)
        sum(o.square().mean() for o in out).backward()
        outs[name] = [o.detach() for o in out]
        grads[name] = {k: p.grad for k, p in net.named_parameters()}
        stats[name] = {k: v.clone() for k, v in net.state_dict().items()}
    for a, b in zip(outs["remat"], outs["plain"]):
        torch.testing.assert_close(a, b)
    for k, g in grads["remat"].items():
        torch.testing.assert_close(g, grads["plain"][k])
    for k, v in stats["remat"].items():
        torch.testing.assert_close(v, stats["plain"][k])
    frozen = grads["frozen"]
    assert frozen["stem_conv.weight"] is None
    assert frozen["layer1_1.conv2.weight"] is None
    assert frozen["layer2_0.conv1.weight"].abs().sum() > 0
    for k in ("stem_bn.running_mean", "layer1_1.bn2.running_var"):
        assert torch.equal(stats["frozen"][k], init[k]), k
    assert not torch.equal(stats["frozen"]["layer2_0.bn1.running_mean"],
                           init["layer2_0.bn1.running_mean"])
    with torch.no_grad():
        dropped = nets["dropblock"].train()(x)
        plain = nets["plain"].train()(x)
    assert torch.equal(dropped[0], plain[0])
    assert not any(torch.equal(d, p) for d, p in zip(dropped[1:], plain[1:]))
