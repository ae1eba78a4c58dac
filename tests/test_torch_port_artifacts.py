"""The port's eval artifacts against the JAX package on the CPU: the rest of
``DetEval`` (per_class_ap, confusion_matrix, prf_at_conf, to_coco_json,
format_classwise and the three PNG savers), the native matcher
(native/cocoeval_core.cpp), ``utils/flops.py``, and ``run_eval`` with
``dump_json`` and ``verbose``.

Tolerances, each with its reason:

* DetEval: integer and count outputs (the confusion matrix, the per-class
  keys, the JSON) exactly; floats (AP, P, R, F1) within 1e-12: both sides
  run the same float64 numpy arithmetic on the same inputs.
* The native matcher: exactly equal to the numpy matcher and to the
  reference's C++ matcher (integers), on quantized IoUs full of ties.
* Parameters: exactly the reference's count.
* GFLOPs: the port counts every multiply-add of the convolutions and
  matrix products from their shapes (FlopCounterMode); XLA's cost model
  skips the taps of a padded convolution that fall in its zero padding,
  and adds elementwise work (BatchNorm, activations, adds) the port does
  not count. Measured here: the port's count is 1.031 times XLA's for the
  tiny YOLOv5 at 128² and 1.167 times for the small FasterRCNN at 64² (a
  3x3 convolution over a 2x2 map is mostly padding). The test holds the
  ratio within [1.0, 1.05] and [1.0, 1.2]. At 640² the padding share is
  below 1 %.
"""

import functools
import json
import logging

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (imported before the JAX package, as its tests do)

from heltondetection_tpu.native import match_dets_native as j_match
from heltondetection_tpu.utils import cocoeval as JC
from heltondetection_tpu.utils.flops import count_params as j_count_params
from heltondetection_tpu.utils.flops import model_complexity as j_complexity

from heltondetection_tpu_torch import native
from heltondetection_tpu_torch.configs import base as p_base
from heltondetection_tpu_torch.engine import runner
from heltondetection_tpu_torch.utils import cocoeval as TC
from heltondetection_tpu_torch.utils.flops import count_params, \
    model_complexity
from heltondetection_tpu_torch.utils.log import LOGGER
from heltondetection_tpu_torch.utils.convert import \
    checkpoint_from_jax_variables

from test_torch_port_eval import _fill
from test_torch_port_model import jax_variables, port_model
from torch_rcnn_refs import SMALL_SIZE, small_rcnn

NC = 4


@functools.lru_cache(maxsize=None)
def _yolo():
    """The tiny YOLOv5 of tests/test_torch_port_model.py and its seeded
    variables."""
    return jax_variables(nc=NC, seed=3, head_scale=0.25)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- DetEval -------------------------------------------------------------------

def _cases():
    """(name, filler) pairs, each filling a DetEval of either package: the
    cases of tests/test_cocoeval.py's artifact tests, and seeded data."""
    def classwise(ev):
        ev.add_gt("im1", [[0, 0, 10, 10]], [0])          # perfect
        ev.add_gt("im1", [[20, 20, 10, 10]], [1])        # missed
        ev.add_det("im1", [[0, 0, 10, 10]], [0.9], [0])
        ev.add_det("im1", [[90, 90, 4, 4]], [0.8], [2])  # no gt anywhere

    def confusion(ev):
        ev.add_gt("im1", [[0, 0, 10, 10], [20, 20, 10, 10],
                          [40, 40, 10, 10]], [0, 1, 2])
        ev.add_det("im1", [[0, 0, 10, 10], [20, 20, 10, 10], [70, 70, 5, 5],
                           [0, 0, 10, 10]], [0.9, 0.8, 0.7, 0.1],
                   [0, 2, 1, 1])
        ev.add_gt("im2", [[0, 0, 10, 10]], [0], ignore=[1])
        ev.add_det("im2", [[0, 0, 10, 10]], [0.9], [0])

    def ignore_and_crowd(ev):
        ev.add_gt("im1", [[0, 0, 10, 10]], [0])
        ev.add_gt("im1", [[0, 0, 12, 12]], [0], ignore=[1])
        ev.add_det("im1", [[0, 0, 10, 10]], [0.9], [0])
        ev.add_gt("im2", [[50, 50, 30, 30]], [1], iscrowd=[1])
        ev.add_det("im2", [[52, 52, 10, 10], [60, 60, 10, 10]], [0.9, 0.8],
                   [1, 1])

    def prf(ev):
        ev.add_gt("im1", [[0, 0, 10, 10], [40, 40, 10, 10]], [0, 0])
        ev.add_det("im1", [[0, 0, 10, 10], [80, 80, 5, 5]], [0.9, 0.6],
                   [0, 0])

    def many_classes(ev):
        for c in range(4):
            ev.add_gt(f"im{c}", [[0, 0, 10, 10]], [c])
            ev.add_det(f"im{c}", [[0, 0, 10, 10]], [0.9], [c])
        ev.add_det(7, [[3.0, 4.0, 5.0, 6.0]], [0.5], [1])

    return [("classwise", classwise), ("confusion", confusion),
            ("ignore_and_crowd", ignore_and_crowd), ("prf", prf),
            ("many_classes", many_classes),
            ("seeded0", lambda ev: _fill(ev, 0)),
            ("seeded1", lambda ev: _fill(ev, 1))]


@pytest.mark.parametrize("name, fill", _cases(), ids=[c[0] for c in _cases()])
def test_deteval_artifacts_match_reference(name, fill):
    got, want = TC.DetEval(NC), JC.DetEval(NC)
    fill(got)
    fill(want)
    pc, wpc = got.per_class_ap(), want.per_class_ap()
    assert pc.keys() == wpc.keys()
    for cat in pc:
        for k in ("AP", "AP50"):
            assert abs(pc[cat][k] - wpc[cat][k]) <= 1e-12, (cat, k)
    assert TC.format_classwise(pc, ["a", "b", "c", "d"]) == \
        JC.format_classwise(wpc, ["a", "b", "c", "d"])
    for kw in ({}, {"conf_thres": 0.05, "iou_thres": 0.3}):
        np.testing.assert_array_equal(got.confusion_matrix(**kw),
                                      want.confusion_matrix(**kw))
    grid = np.array([0.0, 0.5, 0.6, 0.7, 0.9, 0.95])
    for kw in ({}, {"conf_grid": grid, "iou": 0.75}):
        curves, wcurves = got.prf_at_conf(**kw), want.prf_at_conf(**kw)
        assert curves.keys() == wcurves.keys()
        for cat in curves:
            for k in ("conf", "P", "R", "F1"):
                np.testing.assert_allclose(curves[cat][k], wcurves[cat][k],
                                           atol=1e-12, rtol=0)
    for mapping in (None, {c: 10 + c for c in range(NC)}):
        assert got.to_coco_json(mapping) == want.to_coco_json(mapping)
    # the stats after the artifacts, and after a change, are fresh
    s, ws = got.summarize(), want.summarize()
    assert all(abs(s[k] - ws[k]) <= 1e-12 for k in s)
    got.reset_dets()
    assert all(v["AP"] in (0.0, -1.0) for v in got.per_class_ap().values())


def test_png_savers_match_reference(tmp_path):
    """The three PNGs render as the reference's, pixel for pixel (the same
    matplotlib calls), the PR curves in both colour regimes (up to 8
    classes coloured, more in grey), and the P/R/F1 figure returns the
    same mean-F1 peak."""
    import cv2
    small, big = TC.DetEval(2), JC.DetEval(2)
    for ev in (small, big):
        ev.add_gt("im1", [[0, 0, 10, 10], [30, 30, 8, 8]], [0, 1])
        ev.add_det("im1", [[0, 0, 10, 10], [31, 31, 8, 8]], [0.9, 0.7],
                   [0, 1])
    many, wmany = TC.DetEval(12), JC.DetEval(12)
    for ev in (many, wmany):
        for c in range(12):
            ev.add_gt(f"im{c}", [[0, 0, 10, 10]], [c])
            ev.add_det(f"im{c}", [[0, 0, 10, 10]], [0.9 - 0.05 * c], [c])
    for (p, j), names, arts in (((small, big), ["cat", "dog"],
                                 ("cm", "pr", "prf")),
                                ((many, wmany), None, ("pr",))):
        out = {}
        for pkg, ev, mod in (("port", p, TC), ("ref", j, JC)):
            if "cm" in arts:
                mod.save_confusion_png(ev.confusion_matrix(), names,
                                       str(tmp_path / f"{pkg}_cm.png"))
                out[pkg] = mod.save_prf_curves_png(
                    ev, names, str(tmp_path / f"{pkg}_prf.png"))
            mod.save_pr_curves_png(ev, names, str(tmp_path / f"{pkg}_pr.png"))
        assert out.get("port") == out.get("ref")
        for art in arts:
            a = cv2.imread(str(tmp_path / f"port_{art}.png"))
            b = cv2.imread(str(tmp_path / f"ref_{art}.png"))
            assert a is not None and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# -- the native matcher ----------------------------------------------------------

def _numpy_match(ious, g_ig, g_crowd, monkeypatch):
    """The port DetEval's own matching of one (image, category) with the
    native library hidden (its numpy matcher), on given IoUs and flags."""
    ev = TC.DetEval(1)
    d, g = ious.shape
    ev._prep_cache[("im", 0, 100)] = (
        np.zeros((g, 4)), g_crowd, np.full(g, 100.0), g_ig,
        np.zeros((d, 4)), np.linspace(1, 0.5, d), ious)
    with monkeypatch.context() as m:
        m.setattr(native, "_LIB", None)
        m.setattr(native, "_TRIED", True)
        return ev._evaluate_img("im", 0, (0.0, 1e10), 100)


@pytest.mark.parametrize("seed", range(4))
def test_native_matcher_matches_numpy_and_reference(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    d, g = int(rng.integers(1, 40)), int(rng.integers(1, 15))
    ious = np.round(rng.uniform(0, 1, (d, g)) * 8) / 8    # many exact ties
    g_ig = np.sort(rng.integers(0, 2, g)).astype(np.int64)
    g_crowd = (g_ig & rng.integers(0, 2, g)).astype(np.int64)
    calls = native.match_calls
    dtm, dt_ig = native.match_dets_native(TC.IOU_THRS, ious, g_ig, g_crowd)
    assert native.match_calls == calls + 1
    want = j_match(JC.IOU_THRS, ious, g_ig, g_crowd)
    np.testing.assert_array_equal(dtm, want[0])
    np.testing.assert_array_equal(dt_ig, want[1])
    ref = _numpy_match(ious, g_ig, g_crowd, monkeypatch)
    np.testing.assert_array_equal(ref["dt_matched"], dtm >= 0)
    np.testing.assert_array_equal(ref["dt_ignore"], dt_ig.astype(bool))


def test_deteval_uses_the_native_matcher(monkeypatch):
    """DetEval's stats with the native matcher (which it calls) equal those
    of its numpy matcher (the library hidden) and the reference's."""
    assert native.get_cocoeval_lib() is not None, "g++ build failed"
    ev = TC.DetEval(NC)
    _fill(ev, 2)
    calls = native.match_calls
    with_native = ev.summarize()
    assert native.match_calls > calls
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    ev = TC.DetEval(NC)
    _fill(ev, 2)
    calls = native.match_calls
    without = ev.summarize()
    assert native.match_calls == calls
    ref = JC.DetEval(NC)
    _fill(ref, 2)
    want = ref.summarize()
    for k in with_native:
        assert abs(with_native[k] - without[k]) <= 1e-12, k
        assert abs(with_native[k] - want[k]) <= 1e-12, k


# -- flops -------------------------------------------------------------------------

def test_complexity_against_xla():
    jmodel, variables = _yolo()
    got = model_complexity(port_model(variables, NC), 128)
    want = j_complexity(jmodel, variables, 128)
    assert got["mparams"] == want["mparams"]
    assert 1.0 <= got["gflops_per_image"] / want["gflops_per_image"] <= 1.05
    jr, rvars, pr = small_rcnn()
    assert count_params(pr) == j_count_params(rvars["params"])
    got = model_complexity(pr, SMALL_SIZE)
    want = j_complexity(jr, rvars, SMALL_SIZE)
    assert got["mparams"] == want["mparams"]
    assert 1.0 <= got["gflops_per_image"] / want["gflops_per_image"] <= 1.2


# -- run_eval ----------------------------------------------------------------------

class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_run_eval_dump_json_and_artifacts(tmp_path):
    """``run_eval(dump_json=…, verbose=True)`` on a COCO val set: the JSON
    is the reference's ``to_coco_json`` of the same dets (category ids
    mapped back), and the classwise table, the three PNGs, the mean-F1
    line and the FLOPs line come out."""
    from synth_data import build_coco_dataset
    _, variables = _yolo()
    ann, imgs = build_coco_dataset(str(tmp_path / "coco"), n_images=3,
                                   hw=(96, 128), num_classes=NC)
    cfg = p_base.ExperimentConfig(
        name="art", work_dir=str(tmp_path / "runs"),
        model=p_base.ModelConfig(family="yolov5", num_classes=NC,
                                 img_size=128, dtype="float32"),
        data=p_base.DataConfig(val_ann=ann, val_imgs=imgs),
        eval=p_base.EvalConfig(batch_size=2, conf_thres=0.05))
    model = port_model(variables, NC)
    handler = _Lines()
    logging.getLogger(LOGGER).addHandler(handler)
    reuse = {}
    out = tmp_path / "dets.json"
    try:
        stats = runner.run_eval(cfg, model.state_dict(), model,
                                dump_json=str(out), _reuse=reuse,
                                device="cpu")
    finally:
        logging.getLogger(LOGGER).removeHandler(handler)
    assert stats["num_images"] == 3
    det = reuse["det"]
    ref = JC.DetEval(NC)
    for (img, cat), dets in det._dts.items():
        ref.add_det(img, [b for b, _ in dets], [s for _, s in dets],
                    [cat] * len(dets))
    dumped = json.loads(out.read_text())
    assert len(dumped) == sum(len(v) for v in det._dts.values()) > 0
    assert dumped == json.loads(json.dumps(ref.to_coco_json(
        reuse["ds"].label_to_cat)))
    assert {d["category_id"] for d in dumped} <= {10, 11, 12, 13}
    text = "\n".join(handler.lines)
    assert "per-class AP" in text and "AP50" in text
    assert "FLOPs:" in text and "Params: 0.45 M" in text
    assert "mean-F1 peak" in text
    art = tmp_path / "runs" / "art"
    for name in ("confusion_matrix.png", "pr_curve.png", "prf_curve.png"):
        assert (art / name).stat().st_size > 1000
