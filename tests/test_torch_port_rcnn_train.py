"""Parity of the parts of the port's FasterRCNN training with the JAX package
on the CPU, in float32: the balanced sampling, both assigners, the sparse
RPN logits, the losses, RoIAlign's backward pass, the backbones' train-mode
knobs and the freeze set, and ``train.backbone_pretrain``'s graft
(heltondetection_tpu_torch/models/faster_rcnn.py, ops/roi_align.py,
models/cspdarknet.py, engine/runner.py, utils/torch_convert.py).

Torch cannot reproduce ``jax.random``, so the port's sampling runs on the
reference's own uniforms (``torch_rcnn_refs.sampling_draws``). Tolerances:
sampled indices, labels, masks and matched gts exactly; box targets within
1e-5 relative (a log and a division in float32); the sparse RPN logits
within 1e-5 of the largest logit; the losses within 1e-5 relative; the
pyramid's gradient through RoIAlign and RoIPool within 1e-5 of its largest
element (RoIAlign's scatter sums a pixel's taps in another order);
``gradcheck`` in float64 at its default tolerances; the backbones' train
mode outputs within 1e-4 of their largest (batch statistics divide the
packages' rounding differences by each channel's spread) and their running
statistics within 1e-4 relative; the graft exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heltondetection_tpu.configs.base import load_config as j_load_config
from heltondetection_tpu.engine import runner as j_runner
from heltondetection_tpu.models import faster_rcnn as JR
from heltondetection_tpu.models.cspdarknet import CSPDarknet as JCSP
from heltondetection_tpu.models.faster_rcnn import init_faster_rcnn
from heltondetection_tpu.models.resnet import ResNet as JResNet
from heltondetection_tpu.ops import roi_align as JRA
from heltondetection_tpu.utils import torch_convert as JTC

from heltondetection_tpu_torch.configs import base as p_base
from heltondetection_tpu_torch.engine import runner
from heltondetection_tpu_torch.models import faster_rcnn as PR
from heltondetection_tpu_torch.models.backbones import frozen_stage_prefixes
from heltondetection_tpu_torch.models.cspdarknet import CSPDarknet
from heltondetection_tpu_torch.models.resnet import ResNet
from heltondetection_tpu_torch.ops import roi_align as PRA
from heltondetection_tpu_torch.train.schedule import make_optimizer
from heltondetection_tpu_torch.utils import torch_convert as PTC
from heltondetection_tpu_torch.utils.convert import from_jax_variables

from torch_rcnn_refs import draw_variables, load_port, sampling_draws

KEY = jax.random.PRNGKey(0)
SIZE = 128
CONFIG_DIR = os.path.join(os.path.dirname(runner.__file__), "..", "configs")
J_CONFIG_DIR = os.path.join(os.path.dirname(JR.__file__), "..", "configs")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _boxes(rng, shape, size=120.0, lo=4.0, hi=60.0):
    xy = rng.uniform(0, size - hi, shape + (2,))
    wh = rng.uniform(lo, hi, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# sampling and assignment
# ---------------------------------------------------------------------------

SAMPLE_CASES = {
    # name: (n, n_fg, n_bg, batch, pos_frac)
    "fewer-fg-than-quota": (300, 20, 200, 64, 0.5),
    "fg-over-quota-ties": (5000, 1000, 3000, 512, 0.25),
    "zero-fg-quota": (400, 50, 300, 64, 0.0),
    "no-fg": (400, 0, 350, 128, 0.5),
    "fewer-than-batch": (40, 10, 20, 64, 0.5),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_balanced_matches_jax(case):
    """``_sample_balanced`` on the reference's own draws, two rows at once:
    indices, foreground and valid masks exactly. The large case has equal
    final priorities (2 + u·1e-3 in float32 holds about 4,000 values), so
    the stable order shows; a zero quota selects no foreground; a row
    without foreground fills the batch with background."""
    n, n_fg, n_bg, batch, pos_frac = SAMPLE_CASES[case]
    rng = np.random.default_rng(n + n_fg)
    fg = np.zeros((2, n), bool)
    bg = np.zeros((2, n), bool)
    for i in range(2):
        perm = rng.permutation(n)
        fg[i, perm[:n_fg]] = True
        bg[i, perm[n_fg:n_fg + n_bg]] = True
    keys = jax.random.split(jax.random.PRNGKey(n), 2)
    want = jax.jit(jax.vmap(lambda f, b, k: JR._sample_balanced(
        f, b, batch, pos_frac, k)))(fg, bg, keys)
    draws = sampling_draws(keys, n)
    got = PR._sample_balanced(_t(fg), _t(bg), batch, pos_frac, draws)
    for g, w in zip(got, want):
        _same(g, w)
    idx, is_fg, valid = (np.asarray(w) for w in want)
    assert idx.shape == (2, min(batch, n))
    assert is_fg.sum(1).max() <= int(min(batch, n) * pos_frac)
    if case == "zero-fg-quota":
        assert not is_fg.any() and valid.all()
    if case == "no-fg":
        assert not is_fg.any() and valid.sum() == 2 * batch
    if case == "fg-over-quota-ties":
        u_g = draws[2].numpy()
        pri = ((2.0 * is_fg + 1.0 * (valid & ~is_fg)).astype(np.float32) +
               np.take_along_axis(u_g, idx, 1) * np.float32(1e-3))
        assert any(len(np.unique(p[v])) < v.sum() for p, v in zip(pri, valid))


def _anchors():
    return PR.pyramid_anchors(SIZE)[0]


def _gts():
    """Two images' gts (B=2, M=6) xyxy: image 0 with four, one of them a
    sliver whose best anchor is under the foreground IoU (a low-quality
    match) and one masked; image 1 without gts."""
    rng = np.random.default_rng(11)
    gt = _boxes(rng, (2, 6))
    gt[0, 0] = [10.0, 10.0, 13.0, 50.0]            # a sliver
    mask = np.zeros((2, 6), bool)
    mask[0, :4] = True
    mask[0, 2] = False                             # masked
    cls = rng.integers(0, 5, (2, 6)).astype(np.int32)
    return gt, mask, cls


RPN_CFG = dict(num_classes=5, img_size=SIZE, rpn_batch=512, box_batch=32)


def test_assign_rpn_targets_matches_jax():
    """Per image, the reference's ``assign_rpn_targets`` (vmapped, its IoU
    from ``box_iou_matrix``) against the port's batched one (its IoU from
    ``ops.boxes.iou_matrix``) on the same draws: sampled indices,
    foreground, valid and matched gts exactly. Every foreground anchor is
    sampled (a quota of 256): the sliver gt's best anchors are foreground
    only by the low-quality rule; the image without gts has none."""
    anchors = _anchors()
    gt, mask, _ = _gts()
    cfg = PR.RCNNConfig(**RPN_CFG)
    jcfg = JR.RCNNConfig(**RPN_CFG)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    want = jax.jit(jax.vmap(lambda g, m, k: JR.assign_rpn_targets(
        anchors, g, m, jcfg, k)))(gt, mask, keys)
    got = PR.assign_rpn_targets(_t(anchors), _t(gt), _t(mask), cfg,
                                sampling_draws(keys, anchors.shape[0]))
    for g, w in zip(got, want):
        _same(g, w)
    idx, is_fg, valid, matched = (np.asarray(w) for w in want)
    assert is_fg[0].sum() > 0 and not is_fg[1].any() and valid.all()
    iou = np.asarray(JR.box_iou_matrix(anchors, gt[0]))
    assert iou[:, 0].max() < cfg.rpn_fg_iou
    assert int(iou[:, 0].argmax()) in idx[0][is_fg[0]]     # low quality
    assert 2 not in matched[0][is_fg[0]]           # the masked gt got none


def test_assign_box_targets_matches_jax():
    """The second stage on the same draws: the gts appended to the
    proposals (some invalid), rois, labels, foreground and valid exactly,
    box targets (weights 10, 10, 5, 5) within 1e-5 relative."""
    rng = np.random.default_rng(12)
    gt, mask, cls = _gts()
    props = _boxes(rng, (2, 40), lo=8.0)
    props[0, :6] = gt[0] + rng.normal(0, 3, (6, 4)).astype(np.float32)
    pvalid = rng.uniform(size=(2, 40)) < 0.9
    cfg = PR.RCNNConfig(**RPN_CFG)
    jcfg = JR.RCNNConfig(**RPN_CFG)
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    want = jax.jit(jax.vmap(lambda p, v, g, c, m, k: JR.assign_box_targets(
        p, v, g, c, m, jcfg, k)))(props, pvalid, gt, cls, mask, keys)
    got = PR.assign_box_targets(_t(props), _t(pvalid), _t(gt), _t(cls),
                                _t(mask), cfg, sampling_draws(keys, 46))
    rois, labels, reg_t, is_fg, valid = got
    _same(rois, want[0])
    _same(labels, want[1])
    _same(is_fg, want[3])
    _same(valid, want[4])
    np.testing.assert_allclose(reg_t.numpy(), np.asarray(want[2]), rtol=1e-5,
                               atol=1e-6)
    assert is_fg[0].sum() >= 3 and not is_fg[1].any()
    assert (labels[0][is_fg[0]] > 0).all()


# ---------------------------------------------------------------------------
# the sparse RPN logits and the losses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rpn_net():
    """A port FasterRCNN (ResNet18, PAFPNv8, 128²) holding seeded flax
    variables, its pyramid on two frames and the flax RPN parameters."""
    kw = dict(num_classes=5, img_size=SIZE, backbone="resnet18",
              neck="pafpn_v8", head="decoupled")
    jm = JR.FasterRCNN(JR.RCNNConfig(**kw))
    shapes = jax.eval_shape(lambda: init_faster_rcnn(jm, KEY, SIZE))
    variables = draw_variables(shapes, seed=21)
    with torch.device("meta"):
        pm = PR.FasterRCNN(PR.RCNNConfig(**kw))
    pm = load_port(pm.to_empty(device="cpu"), variables)
    x = torch.from_numpy(np.random.default_rng(22).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        pyr, obj, deltas = pm(x)
    return pm, variables["params"]["rpn"], pyr, obj, deltas


def _nhwc(pyr):
    return [p.permute(0, 2, 3, 1).numpy() for p in pyr]


def test_rpn_logits_at_matches_jax_and_dense_head(rpn_net):
    """The RPN head recomputed from 3x3 patches at 300 positions an image,
    every level and the map borders among them: within 1e-5 of the largest
    logit of the reference's ``rpn_logits_at`` and of the port's dense
    head at the same positions."""
    pm, rpn_params, pyr, obj, deltas = rpn_net
    n = obj.shape[1]
    rng = np.random.default_rng(23)
    idx = np.stack([rng.choice(n, 300, replace=False) for _ in range(2)])
    idx[:, :9] = [0, 1, 2, 3 * 31, 3 * 32 * 32 - 1, 3 * 32 * 32,
                  n - 1, n - 3 * 4, n - 3 * 5]
    level_hw = tuple((p.shape[2], p.shape[3]) for p in pyr)
    want = jax.jit(jax.vmap(lambda p, i: JR.rpn_logits_at(
        rpn_params, p, i, level_hw)))(_nhwc(pyr), idx)
    with torch.no_grad():
        got = PR.rpn_logits_at(pm.rpn, pyr, _t(idx))
    dense = (obj.gather(1, _t(idx)),
             deltas.gather(1, _t(idx)[..., None].expand(-1, -1, 4)))
    for g, w, d in zip(got, want, dense):
        top = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * top)
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=0,
                                   atol=1e-5 * top)


def test_losses_match_jax(rpn_net):
    """``smooth_l1`` across its beta; ``rpn_loss`` on dense outputs and
    ``rpn_loss_sparse`` on the pyramid, each image on the reference's
    draws; ``box_head_loss`` with background, foreground and invalid rows:
    within 1e-5 relative."""
    pm, rpn_params, pyr, obj, deltas = rpn_net
    rng = np.random.default_rng(24)
    x = rng.normal(0, 0.3, (1000,)).astype(np.float32)
    np.testing.assert_allclose(PR.smooth_l1(_t(x)).numpy(),
                               np.asarray(JR.smooth_l1(x)), rtol=1e-6)

    anchors = _anchors()
    gt, mask, cls = _gts()
    cfg = PR.RCNNConfig(**RPN_CFG)
    jcfg = JR.RCNNConfig(**RPN_CFG)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    draws = sampling_draws(keys, anchors.shape[0])
    level_hw = tuple((p.shape[2], p.shape[3]) for p in pyr)
    want_dense = jax.jit(jax.vmap(lambda o, d, g, m, k: JR.rpn_loss(
        o, d, anchors, g, m, jcfg, k)))(obj.numpy(), deltas.numpy(), gt,
                                        mask, keys)
    want_sparse = jax.jit(jax.vmap(lambda p, g, m, k: JR.rpn_loss_sparse(
        rpn_params, p, anchors, g, m, jcfg, k, level_hw)))(
            _nhwc(pyr), gt, mask, keys)
    with torch.no_grad():
        got_dense = PR.rpn_loss(obj, deltas, _t(anchors), _t(gt), _t(mask),
                                cfg, draws)
        got_sparse = PR.rpn_loss_sparse(pm.rpn, pyr, _t(anchors), _t(gt),
                                        _t(mask), cfg, draws)
    for got, want in ((got_dense, want_dense), (got_sparse, want_sparse)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    assert float(want_dense[1][0]) > 0 and float(want_dense[1][1]) == 0.0

    b, s, nc = 2, 32, 5
    scores = rng.normal(0, 2, (b, s, nc + 1)).astype(np.float32)
    hd = rng.normal(0, 0.5, (b, s, nc, 4)).astype(np.float32)
    labels = rng.integers(0, nc + 1, (b, s)).astype(np.int32)
    reg_t = rng.normal(0, 0.5, (b, s, 4)).astype(np.float32)
    is_fg = labels > 0
    valid = rng.uniform(size=(b, s)) < 0.8
    want = jax.vmap(JR.box_head_loss)(scores, hd, labels, reg_t, is_fg,
                                      valid)
    got = PR.box_head_loss(_t(scores), _t(hd), _t(labels).long(), _t(reg_t),
                           _t(is_fg), _t(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


# ---------------------------------------------------------------------------
# RoIAlign's backward pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["align", "pool"])
def test_roi_align_backward_matches_jax(method):
    """The pyramid's gradient of ⟨multilevel_roi_align(feats, rois), g⟩
    over a batch of two and four levels (rois of every level, past the
    map's edge, tiny), against ``jax.grad`` through the reference's
    (its custom VJP for align, autodiff's max for pool): within 1e-5 of
    its largest element. The rois get no gradient."""
    rng = np.random.default_rng(31)
    strides = (4, 8, 16, 32)
    size, c, b, r = 256, 8, 2, 50
    feats = [rng.normal(0, 1, (b, size // s, size // s, c)).astype(np.float32)
             for s in strides]
    rois = np.stack([_boxes(rng, (r,), size=300.0, lo=1.0, hi=200.0)
                     for _ in range(b)])
    rois[:, :5] = [[-20, -10, 40, 30], [230, 240, 290, 300],
                   [100, 100, 100.5, 100.5], [0, 0, 256, 256],
                   [-100, -120, 400, 380]]
    g = rng.normal(0, 1, (b, r, 7, 7, c)).astype(np.float32)

    def j_obj(fs):
        out = jax.vmap(lambda f, rs: JRA.multilevel_roi_align(
            list(f), rs, strides, method=method))(fs, rois)
        return jnp.sum(out * g)

    want = jax.jit(jax.grad(j_obj))(feats)
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    trois = torch.from_numpy(rois).requires_grad_()
    out = PRA.multilevel_roi_align(tf, trois, strides, method=method)
    (out * torch.from_numpy(g)).sum().backward()
    assert trois.grad is None
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for t, w in zip(tf, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * top)
    assert all(float(t.grad.abs().sum()) > 0 for t in tf)


def test_roi_align_gradcheck():
    """``torch.autograd.gradcheck`` of RoIAlign's backward in float64: two
    levels of two images, rois on both levels and past an edge."""
    gen = torch.Generator().manual_seed(0)
    feats = [torch.randn(2, 8, 8, 3, dtype=torch.float64, generator=gen,
                         requires_grad=True),
             torch.randn(2, 4, 4, 3, dtype=torch.float64, generator=gen,
                         requires_grad=True)]
    rois = torch.tensor([[[2.0, 3.0, 20.0, 17.0], [1.0, 1.0, 40.0, 40.0],
                          [25.0, 20.0, 40.0, 40.0]],
                         [[0.0, 0.0, 8.0, 8.0], [5.5, 2.5, 41.0, 37.0],
                          [10.0, 12.0, 16.0, 14.0]]], dtype=torch.float64)

    def fn(f0, f1):
        return PRA.multilevel_roi_align([f0, f1], rois, (4, 8), out_size=2,
                                        canonical_size=16.0,
                                        canonical_level=0)

    assert len(torch.unique(PRA._roi_levels(rois.float(), 2, 0, 16.0))) == 2
    assert torch.autograd.gradcheck(fn, tuple(feats))


# ---------------------------------------------------------------------------
# the backbones' train-mode knobs, the freeze set, the graft
# ---------------------------------------------------------------------------

KNOBS = {
    "resnet18-frozen1": ("resnet18", False, 1),
    "resnet18-norm_eval": ("resnet18", True, 0),
    "cspdarknet-frozen1": ("cspdarknet", False, 1),
    "cspdarknet-norm_eval": ("cspdarknet", True, 0),
}


def _backbones(kind, norm_eval, frozen):
    if kind == "resnet18":
        return (JResNet(stage_sizes=(2, 2, 2, 2), block="basic",
                        norm_eval=norm_eval, frozen_stages=frozen),
                ResNet((2, 2, 2, 2), "basic", norm_eval=norm_eval,
                       frozen_stages=frozen))
    return (JCSP(depth_multiple=0.33, width_multiple=0.125, include_c2=True,
                 norm_eval=norm_eval, frozen_stages=frozen),
            CSPDarknet(0.33, 0.125, include_c2=True, norm_eval=norm_eval,
                       frozen_stages=frozen))


@pytest.mark.parametrize("case", list(KNOBS))
def test_backbone_train_knobs_match_jax(case):
    """ResNet18 and CSPDarknet (width 0.125, C2 tapped) in training mode
    with ``norm_eval`` or one frozen stage, against the reference's train
    mode: the features, and the running statistics it moves (none under
    ``norm_eval``; all but the frozen stage's otherwise). In the port the
    frozen stage's parameters get no gradient, and an optimizer over the
    registry's prefixes for that stage leaves them where they were."""
    kind, norm_eval, frozen = KNOBS[case]
    jm, pm = _backbones(kind, norm_eval, frozen)
    x = np.random.default_rng(41).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    shapes = jax.eval_shape(lambda k, v: jm.init(k, v, train=False), KEY, x)
    variables = draw_variables(shapes, seed=42)
    want, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                              mutable=["batch_stats"]))(
        variables, x)
    pm = load_port(pm, variables).train()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    got = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(), w,
                                   rtol=0, atol=1e-4 * np.abs(w).max())
    moved = from_jax_variables({"batch_stats": mut["batch_stats"]})
    after = pm.state_dict()
    frozen_mods = (("stem_", "layer1_") if kind == "resnet18"
                   else ("stem.", "down1.", "c3_1."))
    n_moved = 0
    for k, v in moved.items():
        if "running" not in k:
            continue
        np.testing.assert_allclose(after[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        held = norm_eval or (frozen and k.startswith(frozen_mods))
        assert torch.equal(after[k], before[k]) == held, k
        n_moved += not held
    assert (n_moved == 0) == norm_eval
    if not frozen:
        return
    sum(o.square().mean() for o in got).backward()
    name = "resnet18" if kind == "resnet18" else "cspdarknet_n"
    prefixes = [p.lstrip("/") for p in frozen_stage_prefixes(name, 1, "")]
    opt = make_optimizer(pm, 1e-2, total_steps=4, warmup_steps=0,
                         frozen_prefixes=tuple(prefixes))
    params = {k: p.detach().clone() for k, p in pm.named_parameters()}
    for _ in range(2):                  # the warmup's first step is at lr 0
        opt.step()
    for k, p in pm.named_parameters():
        in_frozen = k.startswith(frozen_mods)
        assert (p.grad is None) == in_frozen, k
        assert torch.equal(p, params[k]) == in_frozen, k


def _rcnn_configs():
    return sorted(p for p in os.listdir(CONFIG_DIR)
                  if p.startswith("faster_rcnn_"))


def test_frozen_prefixes_match_jax_for_every_config():
    """``_frozen_prefixes`` of every FasterRCNN config (and of the
    frozen-backbone YOLOv5 config and a default one) equals the
    reference's."""
    names = _rcnn_configs() + ["yolov5_s_coco_640_dropblock_frozen.py",
                               "yolov5_s_coco_640.py"]
    seen = set()
    for name in names:
        mine = runner._frozen_prefixes(
            p_base.load_config(os.path.join(CONFIG_DIR, name)).model)
        want = j_runner._frozen_prefixes(
            j_load_config(os.path.join(J_CONFIG_DIR, name)).model)
        assert tuple(mine) == tuple(want), name
        seen.add(tuple(mine))
    assert len(seen) >= 3      # the stem and layer1, c3_1's, none


def test_graft_backbone_matches_jax(tmp_path):
    """A torchvision ResNet18 state dict (written by the reference's
    ``export_resnet_state_dict`` from drawn variables, in memory, with an
    ``fc`` head and DataParallel's ``module.`` prefix) grafted onto a port
    FasterRCNN equals the reference's graft, weights and BatchNorm
    statistics exactly; a file of another depth raises, naming keys."""
    shapes = jax.eval_shape(lambda k, x: JResNet(
        stage_sizes=(2, 2, 2, 2), block="basic").init(k, x),
        KEY, jnp.zeros((1, 64, 64, 3)))
    variables = draw_variables(shapes, seed=51)
    sd = JTC.export_resnet_state_dict(variables["params"],
                                      variables["batch_stats"])
    sd["fc.weight"] = np.zeros((10, 512), np.float32)
    path = str(tmp_path / "r18.pth")
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, path)
    plain = str(tmp_path / "r18_plain.pth")
    JTC.save_torch_state_dict(plain, {k: v for k, v in sd.items()
                                      if not k.startswith("fc.")})
    bp, bs = JTC.load_torchvision_resnet(plain)
    want = from_jax_variables({"params": bp, "batch_stats": bs})
    model = runner.build_model(p_base.ModelConfig(family="faster_rcnn",
                                                  backbone="resnet18"), 3)
    assert PTC.graft_backbone(model, path) == len(
        [k for k in want if not k.endswith("num_batches_tracked")])
    own = model.backbone.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(own[k], v), k
    model50 = runner.build_model(p_base.ModelConfig(family="faster_rcnn"), 3)
    with pytest.raises(ValueError, match="layer1_0.conv3.weight"):
        PTC.graft_backbone(model50, plain)


def test_global_norm_accumulates_in_float64():
    """The optimizer's and the step's global gradient norm
    (``schedule.global_norm``) of a 12.8M-element float32 tensor, the size
    of the decoupled head's dense-layer gradient, against float64: within
    1e-7 relative; torch 2.13's float32 ``vector_norm`` is off by 5e-4
    there on the CPU, and so was the port's ``grad_norm`` before it summed
    in float64."""
    from heltondetection_tpu_torch.train.schedule import global_norm
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(12845056, generator=gen) * 0.3 + 0.01
    small = torch.randn(1000, generator=gen)
    exact = float(torch.cat([g.double(), small.double()]).norm())
    got = global_norm([g, small])
    assert got.dtype == torch.float32
    assert abs(float(got) / exact - 1) <= 1e-7
