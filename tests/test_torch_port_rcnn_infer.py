"""Parity of the port's FasterRCNN inference (heltondetection_tpu_torch/
models/faster_rcnn.py and its runner branches) with the flax model on the
CPU, in float32.

Two model shapes, each one module-scoped flax variable tree drawn from a
numpy seed and carried across by ``from_jax_variables`` (strictly):
(FPN, coupled head, RoIPool on P2 alone) and (PAFPNv8, decoupled head,
RoIAlign over P2–P5), both over ResNet18 at 128², 4 classes, 128
pre-NMS and 32 post-NMS proposals. The predictor kernels are scaled
(``torch_rcnn_refs.tame``) so that scores are distinct and unsaturated.
One jitted flax program per shape gives the pyramid, the RPN outputs, the
proposals and the dets. Tolerances: the pyramid and the RPN outputs within
1e-5 of their largest magnitude (float32 convs summed in another order);
proposals and dets position by position with the same valid mask and
classes, boxes within 2e-3 px and scores within 1e-4 (a 1e-5 difference
in a logit moves a decoded box by about 1e-4 px). The NMS predicates
differ (``inter > thr·union`` here, ``inter/union > thr`` in the
reference's XLA fixpoint) only at exact ties, which seeded data does not
hit. ``generate_proposals`` is also held on the same seeded RPN outputs in
both packages: the same order, boxes within 1e-4 px, scores within 1e-6.
"""

import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from heltondetection_tpu.engine.evaluator import Evaluator as JEvaluator
from heltondetection_tpu.engine.evaluator import \
    make_postprocess as j_make_postprocess
from heltondetection_tpu.engine.runner import build_model as j_build_model
from heltondetection_tpu.configs.base import load_config as j_load_config
from heltondetection_tpu.models import faster_rcnn as JR
from heltondetection_tpu.models.faster_rcnn import init_faster_rcnn
from heltondetection_tpu.utils.cocoeval import DetEval as JDetEval

from heltondetection_tpu_torch import cli
from heltondetection_tpu_torch.configs import base as p_base
from heltondetection_tpu_torch.engine import runner
from heltondetection_tpu_torch.engine.evaluator import Evaluator
from heltondetection_tpu_torch.engine.infer import Detector
from heltondetection_tpu_torch.engine.serve import BatchingDetector
from heltondetection_tpu_torch.kernels import launch_counts
from heltondetection_tpu_torch.models import faster_rcnn as PR
from heltondetection_tpu_torch.utils.cocoeval import DetEval
from heltondetection_tpu_torch.utils.convert import (
    checkpoint_from_jax_variables, from_jax_variables)

from torch_rcnn_refs import draw_variables, load_port, tame

SIZE = 128
NC = 4
BASE = dict(num_classes=NC, img_size=SIZE, backbone="resnet18",
            rpn_pre_nms_topk=128, rpn_post_nms_topk=32, score_thresh=0.1,
            nms_thresh=0.5, max_det=20)
SHAPES = {
    "fpn-coupled-roipool-p2": dict(neck="fpn", head="coupled", roi_levels=1,
                                   roi_method="pool"),
    "pafpnv8-decoupled-align-p2p5": dict(neck="pafpn_v8", head="decoupled",
                                         roi_levels=4, roi_method="align"),
}
CONFIG_DIR = os.path.join(os.path.dirname(runner.__file__), "..", "configs")
J_CONFIG_DIR = os.path.join(os.path.dirname(JR.__file__), "..", "configs")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


FRAMES = np.random.default_rng(5).integers(
    0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _models(name):
    """Both packages' model of one shape on one variable tree, tamed on
    FRAMES."""
    torch.set_num_threads(1)
    kw = {**BASE, **SHAPES[name]}
    jm = JR.FasterRCNN(JR.RCNNConfig(**kw))
    shapes = jax.eval_shape(
        lambda: init_faster_rcnn(jm, jax.random.PRNGKey(0), SIZE))
    variables = draw_variables(shapes, seed=len(name))
    x = torch.from_numpy(FRAMES.astype(np.float32) / 255.0)
    with torch.device("meta"):
        pm = PR.FasterRCNN(PR.RCNNConfig(**kw))
    pm = load_port(pm.to_empty(device="cpu"), variables)
    return jm, variables, tame(variables, pm, x)


@functools.lru_cache(maxsize=None)
def _programs():
    """Per shape, the reference's jitted program over FRAMES: the pyramid,
    the RPN outputs, the proposals and ``faster_rcnn_infer``'s dets. Both
    are traced first and then compiled at once, in two threads (XLA's
    compile leaves the interpreter lock)."""
    x = jnp.asarray(FRAMES.astype(np.float32) / 255.0)
    anchors, counts = JR.pyramid_anchors(SIZE)
    lowered = {}
    for name in SHAPES:
        jm, variables, _ = _models(name)

        def program(images, jm=jm, variables=variables):
            # the network's outputs inside faster_rcnn_infer, caught on
            # their way out of FasterRCNN.__call__ (one trace of it)
            caught = []

            def catch(call, args, kwargs, context):
                out = call(*args, **kwargs)
                if context.method_name == "__call__" and \
                        type(context.module) is JR.FasterRCNN:
                    caught.append(out)
                return out

            with nn.intercept_methods(catch):
                dets = JR.faster_rcnn_infer(jm, variables, images, jm.cfg)
            pyr, obj, deltas = caught[0]
            props = jax.vmap(lambda o, d: JR.generate_proposals(
                o, d, anchors, counts, SIZE, jm.cfg))(obj, deltas)
            return pyr, obj, deltas, props, dets

        lowered[name] = jax.jit(program).lower(x)
    # LLVM's expensive passes off: a third less compile time, the same
    # IEEE arithmetic
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(
            lambda low: low.compile(
                {"xla_llvm_disable_expensive_passes": True}),
            lowered.values())))
    return {name: (run, jax.tree.map(np.asarray, run(x)))
            for name, run in compiled.items()}


@pytest.fixture(scope="module", params=list(SHAPES))
def rcnn(request):
    """Both packages' model of one shape, the two frames, and the flax
    program's outputs on them."""
    jm, variables, pm = _models(request.param)
    run, out = _programs()[request.param]
    x = FRAMES.astype(np.float32) / 255.0
    return dict(name=request.param, jm=jm, variables=variables, pm=pm,
                frames=FRAMES, x=torch.from_numpy(x), run=run, want=out)


def _assert_dets(got, want, box_tol=2e-3, score_tol=1e-4):
    """Fixed-shape dets, position by position."""
    gb, gs, gc, gv = (np.asarray(t) for t in got)
    wb, ws, wc, wv = want
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=box_tol)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=score_tol)


def test_network_matches_jax(rcnn):
    """The pyramid P2..P6 and the RPN outputs in (h, w, a) order."""
    pyr, obj, deltas, _, _ = rcnn["want"]
    with torch.no_grad():
        p_pyr, p_obj, p_deltas = rcnn["pm"](rcnn["x"])
    assert len(p_pyr) == len(pyr) == 5
    for got, want in zip(p_pyr, pyr):
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    for got, want in ((p_obj, obj), (p_deltas, deltas)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_faster_rcnn_infer_matches_jax(rcnn):
    """The network's proposals, and the dets of ``faster_rcnn_infer``: the
    same valid mask and classes, boxes within 2e-3 px, scores within
    1e-4; the RPN stage's first launch counts nothing on the CPU."""
    _, _, _, props, dets = rcnn["want"]
    pm = rcnn["pm"]
    before = dict(launch_counts)
    with torch.no_grad():
        p_pyr, p_obj, p_deltas = pm(rcnn["x"])
        p_props = PR.generate_proposals(
            p_obj, p_deltas, pm.anchors("cpu"), PR.pyramid_anchors(SIZE)[1],
            SIZE, pm.cfg)
        got = PR.faster_rcnn_infer(pm, rcnn["x"])
    assert launch_counts == before
    np.testing.assert_array_equal(p_props[2].numpy(), props[2])
    np.testing.assert_allclose(p_props[0].numpy(), props[0], rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(p_props[1].numpy(), props[1], rtol=0,
                               atol=1e-4)
    assert got[3].sum() > 10
    _assert_dets([t.numpy() for t in got], dets)


@pytest.mark.parametrize("pre, post", [(128, 32), (8, 64)])
def test_generate_proposals_matches_jax(pre, post):
    """The same seeded RPN outputs through both: the order, boxes within
    1e-4 px, scores within 1e-6 and the valid mask; at (8, 64) the five
    levels give 40 candidates for 64 proposals, so the rest is padding."""
    cfg_kw = dict(num_classes=NC, img_size=SIZE, rpn_pre_nms_topk=pre,
                  rpn_post_nms_topk=post)
    anchors, counts = JR.pyramid_anchors(SIZE)
    rng = np.random.default_rng(pre)
    n = anchors.shape[0]
    obj = rng.normal(0, 2, (2, n)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (2, n, 4)).astype(np.float32)
    jcfg = JR.RCNNConfig(**cfg_kw)
    want = jax.jit(jax.vmap(lambda o, d: JR.generate_proposals(
        o, d, anchors, counts, SIZE, jcfg)))(jnp.asarray(obj),
                                             jnp.asarray(deltas))
    got = PR.generate_proposals(torch.from_numpy(obj),
                                torch.from_numpy(deltas),
                                torch.from_numpy(PR.pyramid_anchors(SIZE)[0]),
                                PR.pyramid_anchors(SIZE)[1], SIZE,
                                PR.RCNNConfig(**cfg_kw))
    pb, ps, pv = (np.asarray(t) for t in want)
    assert got[0].shape == (2, post, 4)
    np.testing.assert_array_equal(got[2].numpy(), pv)
    np.testing.assert_allclose(got[1].numpy(), ps, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), pb, rtol=0, atol=1e-4)
    if post == 64:
        assert pv.sum(1).max() <= 40 and not pv[:, 40:].any()


def _batch(frames, ids):
    return {"image": frames, "img_id": ids, "scale": [1.0] * len(ids),
            "pad_x": [0.0] * len(ids), "pad_y": [0.0] * len(ids),
            "orig_hw": [(SIZE, SIZE)] * len(ids)}


def test_forward_for_eval_and_evaluator_match_jax(rcnn):
    """``forward_for_eval`` (one-hot class contract) and the single-label
    ``Evaluator``, against the reference's forward and Evaluator on the
    same two frames, gt mined from the reference's own dets (score > 0.3):
    the same AP and AP50 within 1e-3 (the dets differ by up to 1e-4 in
    score, which can reorder near-equal ones in the precision curve)."""
    jm, variables, pm = rcnn["jm"], rcnn["variables"], rcnn["pm"]
    wb, ws, wc, wv = rcnn["want"][4]
    fwd = runner.forward_for_eval(pm, NC, device="cpu")
    boxes, obj, cls = fwd(rcnn["frames"])
    np.testing.assert_allclose(boxes.numpy(), wb, rtol=0, atol=2e-3)
    np.testing.assert_allclose(obj.numpy(), ws, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(cls.numpy().argmax(-1)[wv], wc[wv])
    np.testing.assert_array_equal(cls.numpy().sum(-1), wv.astype(np.float32))

    def gt(det):
        for i in range(2):
            keep = wv[i] & (ws[i] > 0.3)
            b = wb[i][keep]
            det.add_gt(i, np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], 1),
                       wc[i][keep])
        return det

    kw = dict(conf_thres=0.05, iou_thres=0.5, max_det=100, multi_label=False)
    stats = Evaluator(fwd, NC, device="cpu", **kw).run(
        [_batch(rcnn["frames"], [0, 1])], det_eval=gt(DetEval(NC)))
    post = jax.jit(j_make_postprocess(NC, **kw))

    def j_step(images):
        ob, os_, oc, ov = rcnn["run"](images.astype(jnp.float32) / 255.0)[4]
        onehot = jax.nn.one_hot(jnp.maximum(oc, 0), NC) * ov[..., None]
        return post(ob, os_, onehot)

    j_stats = JEvaluator(None, NC, step_fn=j_step, jit_step=False).run(
        [_batch(rcnn["frames"], [0, 1])], det_eval=gt(JDetEval(NC)))
    assert stats["num_images"] == 2 and stats["AP50"] > 0.5
    for key in ("AP", "AP50"):
        assert stats[key] == pytest.approx(j_stats[key], abs=1e-3), key


def _rcnn_configs():
    """One published config per distinct (backbone, neck, head,
    roi_levels) of configs/faster_rcnn_*.py."""
    seen = {}
    for path in sorted(os.listdir(CONFIG_DIR)):
        if not path.startswith("faster_rcnn_"):
            continue
        m = p_base.load_config(os.path.join(CONFIG_DIR, path)).model
        seen.setdefault((m.backbone or "resnet50", m.neck, m.head,
                         m.roi_levels), path)
    return sorted(seen.values())


@pytest.mark.parametrize("name", _rcnn_configs())
def test_state_dict_matches_every_config_shape(name):
    """``build_model`` of a published FasterRCNN config has the keys and
    shapes of ``from_jax_variables`` over the reference's model of the same
    config (``jax.eval_shape``, at a small image size: no parameter depends
    on it), and takes that state dict strictly."""
    cfg = p_base.load_config(os.path.join(CONFIG_DIR, name))
    j_cfg = j_load_config(os.path.join(J_CONFIG_DIR, name))
    nc = cfg.model.num_classes
    # the reference's init traces the box head outside a compact method,
    # where its DropBlock cannot be made; DropBlock has no parameters, so
    # the shapes are those of dropblock_p = 0
    jm = j_build_model(dataclasses.replace(j_cfg.model, dropblock_p=0.0), nc)
    shapes = jax.eval_shape(
        lambda: init_faster_rcnn(jm, jax.random.PRNGKey(0), 64))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = from_jax_variables(zeros)
    model = runner.build_model(cfg.model, nc)
    assert isinstance(model, PR.FasterRCNN)
    mine = model.state_dict()
    assert sorted(mine) == sorted(sd)
    for k, v in mine.items():
        assert tuple(v.shape) == tuple(sd[k].shape), k
    model.load_state_dict(sd, strict=True)
    assert model.dtype == torch.bfloat16
    assert model.cfg.roi_levels == cfg.model.roi_levels


def _config(tmp_path, data=None):
    mc = p_base.ModelConfig(family="faster_rcnn", backbone="resnet18",
                            num_classes=NC, img_size=SIZE, neck="pafpn_v8",
                            head="decoupled", rpn_pre_nms_topk=128,
                            rpn_post_nms_topk=32)
    return p_base.ExperimentConfig(
        name="rcnn_port", work_dir=str(tmp_path), model=mc,
        data=data or p_base.DataConfig(class_names=[f"c{i}"
                                                    for i in range(NC)]),
        eval=p_base.EvalConfig(batch_size=2, conf_thres=0.05, iou_thres=0.5,
                               max_det=100, multi_label=False),
        test=p_base.TestConfig(conf_thres=0.1, iou_thres=0.5))


def test_load_detector_and_serving_match_hand_built(tmp_path):
    """A reference checkpoint carried across by
    ``checkpoint_from_jax_variables`` serves through ``load_detector``
    with the dets of a ``Detector`` built by hand from a port model of the
    config's shape holding the same variables, and through a
    ``BatchingDetector`` with the dets of the same Detector at the bucket's
    batch size."""
    _, variables, _ = _models("pafpnv8-decoupled-align-p2p5")
    cfg = _config(tmp_path)
    ckpt = os.path.join(str(tmp_path), "ckpt")
    checkpoint_from_jax_variables(variables, ckpt, step=3)
    loaded = runner.load_detector(cfg, ckpt=ckpt, device="cpu")
    pm = load_port(runner.build_model(cfg.model, NC), variables)
    assert pm.cfg.rpn_pre_nms_topk == 128 and pm.cfg.backbone == "resnet18"
    by_hand = Detector(None, NC, SIZE,
                       forward_fn=runner.forward_for_eval(
                           pm, NC, device="cpu"),
                       conf_thres=cfg.test.conf_thres,
                       iou_thres=cfg.test.iou_thres, device="cpu")
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, hw + (3,)).astype(np.uint8)
              for hw in ((96, 128), (200, 150))]
    got = loaded.detect_batch(frames)
    want = by_hand.detect_batch(frames)
    assert sum(len(s) for _, s, _ in got) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    with BatchingDetector(loaded, batch_size=2, batch_buckets=(2,)) as bd:
        served = [bd.detect(frames[1], timeout=60)]
    for frame, s in zip(frames[1:], served):
        xb, metas = loaded._letterbox([frame, frame], SIZE)
        o = [t[0].numpy() for t in loaded._detect(xb)]
        ref = loaded._to_source(*o, metas[0], frame.shape[:2])
        for a, b in zip(s, ref):
            np.testing.assert_array_equal(a, b)


def test_cli_eval_runs_faster_rcnn(tmp_path, monkeypatch):
    """``cli.py --mode eval --device cpu`` on a FasterRCNN config file:
    ``run_eval`` scores the config's checkpoint on a COCO val set (the
    unfused route, whatever ``eval.fused`` says); training it with
    ``multi_scale`` is refused, as the reference refuses it."""
    from synth_data import build_coco_dataset
    _, variables, _ = _models("pafpnv8-decoupled-align-p2p5")
    ann, imgs = build_coco_dataset(str(tmp_path / "coco"), n_images=3,
                                   hw=(96, 128), num_classes=NC)
    cfg = _config(tmp_path, p_base.DataConfig(val_ann=ann, val_imgs=imgs))
    checkpoint_from_jax_variables(variables, cfg.ckpt_dir, step=1)
    path = tmp_path / "rcnn_cfg.py"
    path.write_text(
        "from heltondetection_tpu_torch.configs import base as b\n"
        f"config = b.ExperimentConfig(name='rcnn_port', work_dir="
        f"{str(tmp_path)!r}, model=b.ModelConfig(family='faster_rcnn', "
        f"backbone='resnet18', num_classes={NC}, img_size={SIZE}, "
        f"neck='pafpn_v8', head='decoupled', rpn_pre_nms_topk=128, "
        f"rpn_post_nms_topk=32), data=b.DataConfig(val_ann={ann!r}, "
        f"val_imgs={imgs!r}), eval=b.EvalConfig(batch_size=2, "
        f"conf_thres=0.05, iou_thres=0.5, max_det=100, multi_label=False, "
        f"fused=True))\n")
    scored = []
    run_eval = runner.run_eval
    monkeypatch.setattr(runner, "run_eval", lambda *a, **k: scored.append(
        run_eval(*a, **k)))
    assert cli.main(["--mode", "eval", "--config", str(path),
                     "--device", "cpu"]) == 0
    assert len(scored) == 1 and scored[0]["num_images"] == 3
    assert np.isfinite(scored[0]["AP"])
    cfg.train.multi_scale = (0.5, 1.0)
    with pytest.raises(ValueError, match="multi_scale"):
        runner.train_from_datasets(cfg, [], None, device="cpu")
