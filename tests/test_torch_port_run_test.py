"""``--mode test`` of the port (engine/runner.py:run_test and
_save_heatmap_panels, utils/vis.py's panels and PNG writer) and the
unfused select over the standard head (ops/postprocess.py:
fused_select_decode, models/yolov5.py:decode_predictions) against the JAX
package on the CPU.

One reference variable tree per family (the tiny YOLOv5 of width 0.125 at
128², and a ResNet18 FasterRCNN at 64²), carried to the port with
``checkpoint_from_jax_variables``; the reference's ``run_test`` reads the
same tree (its ``_load_eval_variables`` is replaced by a lookup). Frames
are seeded noise of sizes that need no resize in the letterbox (a side at
the model size, the other at most it), so both packages see the same
pixels. Tolerances, each with its reason:

* dets: the same multiset, boxes within 0.1 px and scores within 4e-3 for
  YOLOv5 (its packed serve step's bf16 candidate rows,
  tests/test_torch_port_serve.py), boxes within 2e-3 px and scores within
  1e-4 for FasterRCNN (tests/test_torch_port_rcnn_infer.py);
* a panel function on the same arrays: every pixel within 1 grey level.
  The port's bilinear resize (``data/letterbox.py:resize_bilinear``)
  rounds a float sum where cv2's INTER_LINEAR sums in fixed point; the
  colour table is cv2's own, exactly;
* the panels of ``run_test``: the same files and widths (one panel of the
  image's size a level: 3 for YOLOv5, 5 for FasterRCNN), pixels within 1
  grey level at least 99 % of the time. The two networks' maps differ by
  about 1e-5, which can move a map's value across one of the 256 levels of
  its colour index (a step of up to 4 in the table);
* ``fused_select_decode`` and ``decode_predictions``: boxes within 1e-4
  px, scores within 1e-6 and classes exactly on inputs without ties.
"""

import os
from concurrent.futures import ThreadPoolExecutor
import textwrap

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heltondetection_tpu.engine.runner as j_runner
import heltondetection_tpu.models.cspdarknet as j_csp
from heltondetection_tpu.configs import base as j_base
from heltondetection_tpu.models import faster_rcnn as JR
from heltondetection_tpu.models.yolov5 import \
    decode_predictions as j_decode_predictions
from heltondetection_tpu.ops import postprocess as JP
from heltondetection_tpu.utils import vis as JV

import heltondetection_tpu_torch.models.cspdarknet as p_csp
from heltondetection_tpu_torch import cli
from heltondetection_tpu_torch.configs import base as p_base
from heltondetection_tpu_torch.engine import runner
from heltondetection_tpu_torch.models.yolov5 import decode_predictions
from heltondetection_tpu_torch.ops import postprocess as TP
from heltondetection_tpu_torch.utils import vis as TV
from heltondetection_tpu_torch.utils.convert import \
    checkpoint_from_jax_variables

from test_torch_port_model import WIDTH, jax_variables
from test_torch_port_serve import _assert_same_dets
from torch_rcnn_refs import SMALL_SIZE as RSIZE
from torch_rcnn_refs import small_frame, small_rcnn

NC, SIZE = 4, 128
NAMES = ("a", "b", "c", "d")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _JitApply:
    """A flax model whose ``apply`` is jitted."""

    def __init__(self, model):
        self._model = model
        self.apply = jax.jit(model.apply, static_argnames=("train", "method"))

    def __getattr__(self, name):
        return getattr(self._model, name)


@pytest.fixture()
def reuse_reference_programs(monkeypatch):
    """The reference's ``run_test`` with its programs compiled once: its
    ``_save_heatmap_panels`` with the model's ``apply`` and
    ``generate_proposals`` jitted (op by op, its eager apply compiles every
    operation of the network on the CPU: 20 s for the FasterRCNN; jitted,
    2-3 s), and ``make_packed_serve_step`` kept per model, weights and
    settings, so that a second ``run_test`` of the same checkpoint reuses
    the compiled step as one process serving it would. The arithmetic is
    XLA's either way."""
    from heltondetection_tpu.engine import evaluator as j_evaluator
    make_step = j_evaluator.make_packed_serve_step
    steps = {}

    def kept_step(model, variables, nc, **kw):
        key = (model, id(variables), nc, tuple(sorted(kw.items())))
        if key not in steps:
            steps[key] = make_step(model, variables, nc, **kw)
        return steps[key]

    monkeypatch.setattr(j_evaluator, "make_packed_serve_step", kept_step)
    panels = j_runner._save_heatmap_panels
    proxies = {}

    def jitted(cfg, model, variables, source, out_path):
        proxy = proxies.setdefault(model, _JitApply(model))
        return panels(cfg, proxy, variables, source, out_path)

    monkeypatch.setattr(j_runner, "_save_heatmap_panels", jitted)
    monkeypatch.setattr(JR, "generate_proposals", jax.jit(
        JR.generate_proposals, static_argnums=(3, 4, 5)))


@pytest.fixture()
def tiny_variant(monkeypatch):
    monkeypatch.setitem(j_csp.VARIANTS, "t", (0.33, WIDTH))
    monkeypatch.setitem(p_csp.VARIANTS, "t", (0.33, WIDTH))


def _noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


def _write_image(path, shape, seed):
    assert cv2.imwrite(str(path), _noise(shape, seed)[..., ::-1])
    return str(path)


# -- the panels and the PNG writer --------------------------------------------

def _close(got, want, levels=1):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= levels


@pytest.mark.parametrize("panel", ["feature", "obj", "cls_score", "rpn",
                                   "rcnn_cls"])
def test_panels_match_reference(panel):
    """Each panel function on the same seeded arrays: the reference's panel
    (cv2's colour map and resize) within 1 grey level, as wide as its
    levels."""
    rng = np.random.default_rng(7)
    img = _noise((64, 80, 3), 1)
    hw = [(8, 10), (4, 5), (2, 3)]
    if panel == "feature":
        feats = [rng.normal(size=(h, w, 16)).astype(np.float32)
                 for h, w in hw]
        args = (img, feats)
        kw = {}
    elif panel in ("obj", "cls_score"):
        args = (img, [rng.normal(size=(h, w, 3 * (5 + NC))) for h, w in hw],
                NC)
        kw = {"kind": "obj" if panel == "obj" else "cls"}
    elif panel == "rpn":
        hw = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
        args = (img, hw, rng.normal(size=sum(3 * h * w for h, w in hw)))
        kw = {}
    else:
        hw = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
        xy = rng.uniform(0, 60, (40, 2))
        rois = np.concatenate([xy, xy + rng.uniform(2, 50, (40, 2))], -1)
        args = (img, hw, (4, 8, 16, 32, 64), rois,
                rng.uniform(size=(40, NC)), rng.uniform(size=40) > 0.2)
        kw = {"num_pooled": 4, "canonical_size": 24.0}
    name = {"feature": "feature_heatmaps", "obj": "objectness_maps",
            "cls_score": "objectness_maps", "rpn": "rpn_objectness_maps",
            "rcnn_cls": "rcnn_class_score_maps"}[panel]
    got = getattr(TV, name)(*args, **kw)
    want = getattr(JV, name)(*args, **kw)
    assert got.shape == (64, 80 * len(hw), 3)
    _close(got, want)


def test_colour_table_and_png_writer(tmp_path):
    """The JET table is cv2's COLORMAP_JET exactly; an RGB image written
    by write_png reads back with cv2 equal to its input; anything but
    (H, W, 3) uint8 raises."""
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_JET)[:, 0, ::-1]
    np.testing.assert_array_equal(TV._JET, lut)
    rgb = _noise((37, 53, 3), 2)
    TV.write_png(str(tmp_path / "rgb.png"), rgb)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "rgb.png"))[..., ::-1], rgb)
    for bad in (rgb.astype(np.float32), rgb[..., 0]):
        with pytest.raises(ValueError):
            TV.write_png(str(tmp_path / "bad.png"), bad)


# -- fused_select_decode and decode_predictions ---------------------------------

def _raw_maps(seed, b=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 2, (b, h, w, 3 * (5 + NC))).astype(np.float32)
            for h, w in ((16, 16), (8, 8), (4, 4))]


def test_fused_select_decode_matches_reference():
    """The standard head's select-then-decode against the reference's, and
    make_fused_postprocess choosing it for raw maps."""
    raw = _raw_maps(11)
    kw = dict(topk=64, conf_thres=0.05, max_cls_per_box=2)
    got = TP.fused_select_decode([torch.from_numpy(r) for r in raw], NC, **kw)
    want = jax.jit(lambda r: JP.fused_select_decode(r, NC, **kw))(
        [jnp.asarray(r) for r in raw])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # make_fused_postprocess picks this select for raw maps (the packed
    # head's per-level tuples take fused_select_decode_packed)
    post = TP.make_fused_postprocess(NC, pre_nms_topk=64, max_det=20,
                                     conf_thres=0.05, max_cls_per_box=2)
    dets = post([torch.from_numpy(r) for r in raw])
    want = TP.nms_sorted_candidates(*got, iou_thres=0.65, max_det=20)
    for d, w in zip(dets, want):
        assert torch.equal(d, w)


def test_decode_predictions_matches_reference():
    raw = _raw_maps(12)
    got = decode_predictions([torch.from_numpy(r) for r in raw], NC)
    want = jax.jit(lambda r: j_decode_predictions(r, NC))(
        [jnp.asarray(r) for r in raw])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# -- run_test ------------------------------------------------------------------

def _port_config(tmp_path, model: str, size: int) -> str:
    path = tmp_path / "cfg.py"
    path.write_text(textwrap.dedent(f"""
        from heltondetection_tpu_torch.configs.base import (
            DataConfig, ExperimentConfig, ModelConfig, TestConfig)

        config = ExperimentConfig(
            name="port", work_dir={str(tmp_path / "runs")!r},
            data=DataConfig(class_names={NAMES!r}),
            model=ModelConfig({model}, img_size={size}, dtype="float32"),
            test=TestConfig(conf_thres=0.3, iou_thres=0.65,
                            save_heatmaps=True))
        """))
    return str(path)


def _jax_config(tmp_path, size: int, **model_kw):
    return j_base.ExperimentConfig(
        name="ref", work_dir=str(tmp_path / "ref_runs"),
        data=j_base.DataConfig(class_names=NAMES),
        model=j_base.ModelConfig(img_size=size, dtype="float32", **model_kw),
        test=j_base.TestConfig(conf_thres=0.3, iou_thres=0.65,
                               save_heatmaps=True))


def _panels_close(got_path, want_path, levels, size):
    got = cv2.imread(got_path)
    want = cv2.imread(want_path)
    assert got.shape == want.shape == (size, size * levels, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff <= 1).mean() >= 0.99


def _run_both(tmp_path, monkeypatch, jcfg, variables, port_cfg, source,
              name):
    """The reference's run_test and the port's (the CLI's runner call) on
    one source, each into its own output directory; the reference runs in
    a thread meanwhile (XLA's compiles leave the interpreter lock to the
    port)."""
    monkeypatch.setattr(j_runner, "_load_eval_variables",
                        lambda cfg, model=None: variables)
    out_j = tmp_path / "ref_out"
    out_p = tmp_path / "port_out"
    out_j.mkdir(exist_ok=True)
    out_p.mkdir(exist_ok=True)
    with ThreadPoolExecutor(1) as pool:
        want = pool.submit(j_runner.run_test, jcfg, source,
                           str(out_j / name))
        got = runner.run_test(p_base.load_config(port_cfg), source,
                              str(out_p / name), device="cpu")
        want = want.result()
    return got, want, out_p, out_j


def test_run_test_yolov5_image_directory_and_video(tiny_variant, tmp_path,
                                                    monkeypatch,
                                                    reuse_reference_programs):
    """YOLOv5 (the packed serve step): an image with its three panel files
    (3 levels × 128² each), a directory of two images, and a video of three
    frames, each against the reference's run_test from the same weights;
    then ``cli --mode test``."""
    _, variables = jax_variables(nc=NC, seed=3, head_scale=0.25)
    cfg_path = _port_config(tmp_path, "family='yolov5', variant='t', "
                                      "num_classes=4", SIZE)
    checkpoint_from_jax_variables(variables,
                                  p_base.load_config(cfg_path).ckpt_dir,
                                  step=1)
    jcfg = _jax_config(tmp_path, SIZE, family="yolov5", variant="t",
                       num_classes=NC)
    img = _write_image(tmp_path / "frame.png", (SIZE, SIZE, 3), 21)
    got, want, out_p, out_j = _run_both(tmp_path, monkeypatch, jcfg,
                                        variables, cfg_path, img, "o.png")
    _assert_same_dets((got["boxes"], got["scores"], got["classes"]),
                      (np.asarray(want["boxes"]), np.asarray(want["scores"]),
                       np.asarray(want["classes"])))
    assert sorted(os.listdir(out_p)) == sorted(os.listdir(out_j)) == [
        "o.png", "o_heatmaps.png", "o_objmaps.png"]
    assert got["heatmaps"] == str(out_p / "o_heatmaps.png")
    for panel in ("o_heatmaps.png", "o_objmaps.png"):
        _panels_close(str(out_p / panel), str(out_j / panel), 3, SIZE)

    src = tmp_path / "images"
    src.mkdir()
    _write_image(src / "x.png", (SIZE, SIZE, 3), 22)
    _write_image(src / "y.jpg", (96, SIZE, 3), 23)
    (src / "notes.txt").write_text("not an image")
    got, want, out_p, out_j = _run_both(tmp_path, monkeypatch, jcfg,
                                        variables, cfg_path, str(src), "dir")
    assert got["images"] == want["images"] == 2
    assert sorted(os.listdir(got["out_dir"])) == \
        sorted(os.listdir(want["out_dir"])) == [
            "x.png", "x_heatmaps.png", "x_objmaps.png", "y.jpg",
            "y_heatmaps.png", "y_objmaps.png"]

    video = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 5,
                             (SIZE, 96))
    for seed in range(3):
        writer.write(_noise((96, SIZE, 3), 30 + seed))
    writer.release()
    got, want, out_p, out_j = _run_both(tmp_path, monkeypatch, jcfg,
                                        variables, cfg_path, video, "v.mp4")
    assert got == want == {"frames": 3}
    assert os.path.getsize(out_p / "v.mp4") > 0

    printed = []
    monkeypatch.setattr("builtins.print", printed.append)
    assert cli.main(["--mode", "test", "--config", cfg_path, "--source", img,
                     "--out", str(tmp_path / "cli.png"), "--device",
                     "cpu"]) == 0
    assert os.path.exists(tmp_path / "cli_objmaps.png")
    assert set(printed[0]) == {"boxes", "scores", "classes", "heatmaps"}
    with pytest.raises(SystemExit):
        cli.main(["--mode", "test", "--config", cfg_path])


def test_run_test_faster_rcnn_image(tmp_path, monkeypatch,
                                    reuse_reference_programs):
    """FasterRCNN on an image: its dets and three panel files (5 levels ×
    64² each: pyramid activations, RPN objectness, the box head's class
    scores over the proposals) against the reference's run_test."""
    _, variables, _ = small_rcnn()
    model = ("family='faster_rcnn', backbone='resnet18', num_classes=4, "
             "rpn_pre_nms_topk=128, rpn_post_nms_topk=32")
    cfg_path = _port_config(tmp_path, model, RSIZE)
    checkpoint_from_jax_variables(variables,
                                  p_base.load_config(cfg_path).ckpt_dir,
                                  step=1)
    jcfg = _jax_config(tmp_path, RSIZE, family="faster_rcnn",
                       backbone="resnet18", num_classes=4,
                       rpn_pre_nms_topk=128, rpn_post_nms_topk=32)
    img = str(tmp_path / "frame.png")
    assert cv2.imwrite(img, small_frame()[..., ::-1])
    got, want, out_p, out_j = _run_both(tmp_path, monkeypatch, jcfg,
                                        variables, cfg_path, img, "r.png")
    gb, gs, gc = got["boxes"], got["scores"], got["classes"]
    wb, ws, wc = (np.asarray(want[k]) for k in ("boxes", "scores",
                                                "classes"))
    assert len(gs) == len(ws) > 0
    order_g, order_w = np.argsort(-gs, kind="stable"), \
        np.argsort(-ws, kind="stable")
    np.testing.assert_array_equal(gc[order_g], wc[order_w])
    np.testing.assert_allclose(gb[order_g], wb[order_w], atol=2e-3, rtol=0)
    np.testing.assert_allclose(gs[order_g], ws[order_w], atol=1e-4, rtol=0)
    assert sorted(os.listdir(out_p)) == sorted(os.listdir(out_j)) == [
        "r.png", "r_clsmaps.png", "r_heatmaps.png", "r_objmaps.png"]
    for panel in ("r_heatmaps.png", "r_objmaps.png", "r_clsmaps.png"):
        _panels_close(str(out_p / panel), str(out_j / panel), 5, RSIZE)
