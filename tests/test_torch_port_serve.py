"""The port's whole serve slice against the JAX package on the CPU: the
packed serve step and the Detector on the same weights and uint8 noise
images, the letterbox, the CUDA-by-default entry points and the package's
import hygiene.

Det sets are compared as multisets: the same count and classes, each det
paired one to one with the nearest det of its class. The two networks'
float32 logits agree only to ~1e-4 (tests/test_torch_port_model.py), so
where a candidate's bf16 row rounded the other way in the two stacks a box
edge moves by up to ~0.1 px and a score by up to 4e-3 (one bf16 ulp of a
class logit, through σ). Those are the bounds; at least 95 % of the dets
must still agree to 1e-2 px and 1e-5 in score.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heltondetection_tpu.data.augment import letterbox_np as j_letterbox_np
from heltondetection_tpu.engine.evaluator import \
    make_packed_serve_step as j_make_packed_serve_step
from heltondetection_tpu.engine.infer import Detector as JDetector

import heltondetection_tpu_torch.device as port_device
from heltondetection_tpu_torch.data.letterbox import letterbox_np
from heltondetection_tpu_torch.engine.evaluator import (Evaluator,
                                                       make_packed_serve_step)
from heltondetection_tpu_torch import cli
from heltondetection_tpu_torch.configs.base import load_config
from heltondetection_tpu_torch.engine.infer import Detector
from heltondetection_tpu_torch.engine.runner import (forward_for_eval,
                                                     load_detector, run_train)
from heltondetection_tpu_torch.engine.serve import BatchingDetector
from heltondetection_tpu_torch.kernels import launch_counts
from heltondetection_tpu_torch.models.yolov5 import build_yolov5

from test_torch_port_model import jax_variables, port_model

ROOT = pathlib.Path(__file__).resolve().parent.parent
NC, SIZE, CONF, IOU, TOPK = 4, 128, 0.3, 0.65, 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """(flax model, its variables, the port's model) on one set of weights.
    The head is scaled to 0.25 so that scores spread over (0, 1) rather
    than saturating at 1.0, where ties would make the capped candidate sets
    arbitrary."""
    jmodel, variables = jax_variables(nc=NC, seed=3, head_scale=0.25)
    return jmodel, variables, port_model(variables, NC)


def make_steps(weights, **kw):
    """(JAX serve step, port serve step) with the same settings."""
    jmodel, variables, pmodel = weights
    kw = dict(conf_thres=CONF, iou_thres=IOU, pre_nms_topk=TOPK, **kw)
    return (j_make_packed_serve_step(jmodel, variables, NC, **kw),
            make_packed_serve_step(pmodel, NC, device="cpu", **kw))


def _noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


def _assert_same_dets(got, want):
    """The same det multiset: each det is paired with the nearest det of its
    class in box and score, each measured against its bound; the pairing
    must be one to one, within the bounds of the module docstring."""
    gb, gs, gc = got
    wb, ws, wc = want
    assert len(gs) == len(ws) > 0
    assert sorted(gc.tolist()) == sorted(wc.tolist())
    db = np.abs(gb[:, None, :] - wb[None, :, :]).max(-1)
    ds = np.abs(gs[:, None] - ws[None, :])
    dist = np.maximum(db / 0.1, ds / 4e-3)
    dist[gc[:, None] != wc[None, :]] = np.inf
    match = dist.argmin(1)
    assert len(set(match.tolist())) == len(match)          # one to one
    rows = np.arange(len(match))
    assert dist[rows, match].max() <= 1.0
    exact = (db[rows, match] <= 1e-2) & (ds[rows, match] <= 1e-5)
    assert exact.mean() >= 0.95, exact.mean()


SMALL_ANCHORS = (((6, 8), (12, 20), (24, 16)), ((20, 40), (40, 30), (40, 80)),
                 ((80, 60), (100, 130), (250, 220)))


@pytest.mark.parametrize("kw", [{}, {"multi_label": False,
                                     "anchors": SMALL_ANCHORS}],
                         ids=["default", "single-label-anchors"])
def test_serve_step_matches_jax(weights, kw):
    """(f) make_packed_serve_step against the JAX serve step (XLA fixpoint
    NMS on the CPU): the same dets per image, NMS doing real work, and no
    kernel launch on the CPU path."""
    jstep, pstep = make_steps(weights, **kw)
    imgs = _noise((2, SIZE, SIZE, 3), seed=11)
    _, _, _, no_nms = make_packed_serve_step(
        weights[2], NC, conf_thres=CONF, iou_thres=1.01, pre_nms_topk=TOPK,
        device="cpu", **kw)(torch.from_numpy(imgs))
    jb, js, jc, jv = (np.asarray(t) for t in jax.jit(jstep)(
        jnp.asarray(imgs)))
    before = dict(launch_counts)
    out = pstep(torch.from_numpy(imgs))
    assert launch_counts == before
    tb, ts, tc, tv = (t.numpy() for t in out)
    assert tb.shape == (2, TOPK, 4) and tv.dtype == bool
    assert np.isfinite(tb).all() and np.isfinite(ts).all()
    for i in range(2):
        assert 0 < tv[i].sum() < no_nms[i].sum()     # NMS removed some
        _assert_same_dets((tb[i][tv[i]], ts[i][tv[i]], tc[i][tv[i]]),
                          (jb[i][jv[i]], js[i][jv[i]], jc[i][jv[i]]))


def test_detector_matches_jax_detector(weights):
    """(f) Detector.detect_batch on mixed-size frames (largest side =
    img_size, so the letterbox only pads and both stacks see the same
    pixels) against the JAX Detector, in source coordinates."""
    jstep, pstep = make_steps(weights)
    frames = [_noise((96, SIZE, 3), 21), _noise((SIZE, 80, 3), 22),
              _noise((SIZE, SIZE, 3), 23)]
    want = JDetector(None, NC, SIZE, detect_fn=jstep).detect_batch(frames)
    got = Detector(pstep, NC, SIZE, device="cpu").detect_batch(frames)
    assert len(got) == len(frames)
    for (gb, gs, gc), (wb, ws, wc), f in zip(got, want, frames):
        assert (gb[:, [0, 2]] <= f.shape[1]).all()
        assert (gb[:, [1, 3]] <= f.shape[0]).all()
        _assert_same_dets((gb, gs, gc), (wb, ws, wc))
    det = Detector(pstep, NC, SIZE, device="cpu")
    for a, b in zip(det.detect_image(frames[0]),
                    det.detect_batch(frames[:1])[0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(100, 160), (101, 160), (50, 30), (128, 128),
                                (200, 90)])
def test_letterbox_matches_cv2(hw):
    """(g) the same scale and pads as cv2's letterbox_np, pixels within one
    grey level (cv2 interpolates uint8 in fixed point), boxes mapped alike."""
    img = _noise(hw + (3,), seed=hw[0])
    boxes = np.array([[1.0, 2.0, 20.0, 30.0]], np.float32)
    got, gboxes, gmeta = letterbox_np(img, boxes, 128)
    want, wboxes, wmeta = j_letterbox_np(img, boxes, 128)
    assert gmeta == wmeta
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_allclose(gboxes, wboxes, atol=1e-5)


class _CudaDetectorStub:
    """What BatchingDetector reads of a Detector that sits on a CUDA
    device."""
    tta, img_size, device = False, SIZE, torch.device("cuda", 0)


def _warmup_on_cuda_detector():
    batcher = BatchingDetector(_CudaDetectorStub(), batch_size=2)
    try:
        batcher.warmup()
    finally:
        assert batcher.close(timeout=30.0)


@pytest.mark.parametrize("entry", ["resolve_device", "build_yolov5",
                                   "make_packed_serve_step", "Detector",
                                   "Evaluator", "forward_for_eval",
                                   "load_detector", "BatchingDetector.warmup",
                                   "cli", "forward_for_eval_rcnn",
                                   "load_detector_rcnn", "cli_eval_rcnn",
                                   "cli_serve_rcnn", "run_train_rcnn"])
def test_entry_points_raise_without_cuda(entry, weights, monkeypatch):
    """(h) with no CUDA, every entry point raises unless device="cpu", for
    a YOLOv5 and a FasterRCNN config alike."""
    from heltondetection_tpu_torch.configs.base import ModelConfig
    from heltondetection_tpu_torch.engine.runner import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    model = weights[2]
    configs = ROOT / "heltondetection_tpu_torch" / "configs"
    config = str(configs / "yolov5_s_coco_640.py")
    rcnn_config = str(configs / "faster_rcnn_pafpn_decoupled_coco_832.py")
    call = {
        "resolve_device": lambda: port_device.resolve_device(),
        "build_yolov5": lambda: build_yolov5("n", NC),
        "make_packed_serve_step": lambda: make_packed_serve_step(model, NC),
        "Detector": lambda: Detector(lambda x: x, NC, SIZE),
        "Evaluator": lambda: Evaluator(lambda x: x, NC),
        "forward_for_eval": lambda: forward_for_eval(model, NC),
        "load_detector": lambda: load_detector(config),
        "BatchingDetector.warmup": _warmup_on_cuda_detector,
        "cli": lambda: cli.main(["--mode", "serve", "--config", config]),
        "forward_for_eval_rcnn": lambda: forward_for_eval(build_model(
            ModelConfig(family="faster_rcnn", backbone="resnet18"), NC), NC),
        "load_detector_rcnn": lambda: load_detector(rcnn_config),
        "cli_eval_rcnn": lambda: cli.main(["--mode", "eval", "--config",
                                           rcnn_config]),
        "cli_serve_rcnn": lambda: cli.main(["--mode", "serve", "--config",
                                            rcnn_config]),
        "run_train_rcnn": lambda: run_train(load_config(rcnn_config)),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_bad_arguments_raise(weights):
    """A Detector needs exactly one of a step and a forward; a class count
    other than the model's would read the wrong head lanes."""
    with pytest.raises(ValueError, match="exactly one"):
        Detector(None, NC, SIZE, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        Detector(lambda x: x, NC, SIZE, forward_fn=lambda x: x, device="cpu")
    with pytest.raises(ValueError, match="num_classes"):
        make_packed_serve_step(weights[2], NC + 1, device="cpu")


def test_import_leaves_jax_out():
    """(i) importing the whole port (the config files and the CLI
    included) pulls in neither jax, flax, orbax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import heltondetection_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'orbax', 'heltondetection_tpu')]\n"
        "print(len(list(pkgutil.walk_packages(pkg.__path__))), bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_sources_import_nothing_of_jax():
    """(i) no import of jax, flax, orbax or heltondetection_tpu in the
    port's sources or in chip_smoke.py."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|orbax|"
                     r"heltondetection_tpu)(\.|\s|$)", re.M)
    files = sorted((ROOT / "heltondetection_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 50
    for f in files:
        assert not pat.search(f.read_text()), f
