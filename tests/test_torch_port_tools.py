"""The port's two user tools (heltondetection_tpu_torch/tools/) against the
JAX package's (tools/autoanchor.py, tools/eval_ultralytics_weights.py) on
the CPU, on the same files made from numpy seeds. The JAX tools are loaded
from their files with importlib and run on the same command lines.

Tolerances, each with its reason:

* autoanchor: the printed text letter for letter. Both packages fit with
  the same numpy arithmetic on the same labels.
* eval_ultralytics_weights in float: the stats within 1e-6, as
  tests/test_torch_port_eval.py holds the Evaluator on a tiny YOLOv5; the
  dets the same multiset, each with its image and class, boxes within
  0.05 px and scores within 2.5e-5, the bounds of decode_full in
  tests/test_torch_port_model.py (the raw maps differ in the last bits
  of each conv's sums). The detect layers are scaled so that the logits
  have std 2 on the frames: the scores do not tie.
* --int8 layer and flow: tests/test_torch_port_int8.py's bounds for
  ``run_eval`` with ``eval.int8``: AP and AP50 within 1e-6, the dets the
  same multiset with boxes within 0.1 px and scores within 4e-3. Both
  modes quantize with the reference's calibration statistics, as that
  file's flow-mode test does, and the port's own statistics, computed by
  the tool on the same frames, are held to them within rtol 1e-4 and an
  atol of 1e-5 of each statistic's largest value (the raw maps' bound:
  these random weights reach activations of about 250, and the last bits
  of those move a statistic near 0.2 by 2e-4). The packages' scales then
  differ in their last bits (up to 3e-6 relative), and on random weights
  one int8 code moved across a rounding boundary by that changes dets
  downstream: on these frames the layer mode's own calibration gives the
  reference's stats within 1e-6 but other dets on one of the four frames.
"""

import argparse
import importlib.util
import os
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heltondetection_tpu.engine.runner  # noqa: F401  (both JAX tools' import)
from heltondetection_tpu.models.yolov5 import build_yolov5 as j_build_yolov5
from heltondetection_tpu.ops import quant as JQ
from heltondetection_tpu.utils import cocoeval as JC
from heltondetection_tpu.utils.torch_convert import (
    export_yolov5_state_dict as j_export, save_torch_state_dict as j_save)

from heltondetection_tpu_torch.data.autoanchor import (dataset_label_wh,
                                                       fit_anchors)
from heltondetection_tpu_torch.data.letterbox import letterbox_np
from heltondetection_tpu_torch.data.readers import COCODataset
from heltondetection_tpu_torch.models.yolov5 import YOLOv5, calibrate_bn
from heltondetection_tpu_torch.ops import quant as PQ
from heltondetection_tpu_torch.tools import autoanchor as p_autoanchor
from heltondetection_tpu_torch.tools import eval_ultralytics_weights as p_eval
from heltondetection_tpu_torch.utils.convert import from_jax_variables

from synth_data import build_coco_dataset
from torch_rcnn_refs import draw_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_SIZE, EVAL_FRAMES, LOGIT_STD = 64, 4, 2.0
TOLS = {None: (0.05, 2.5e-5), "layer": (0.1, 4e-3), "flow": (0.1, 4e-3)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_tool(name):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parsing(argv):
    """An ``argparse`` stand-in for one module whose parsers read ``argv``
    instead of ``sys.argv``, so that tool runs in threads do not share
    it."""
    class Parser(argparse.ArgumentParser):
        def parse_args(self, args=None, namespace=None):
            return super().parse_args(argv if args is None else args,
                                      namespace)

    return types.SimpleNamespace(ArgumentParser=Parser)


# -- autoanchor ------------------------------------------------------------------

CONFIG = """\
from heltondetection_tpu{pkg}.configs.base import (DataConfig,
                                                  ExperimentConfig,
                                                  ModelConfig)
config = ExperimentConfig(
    name="autoanchor",
    data=DataConfig(format="coco", train_ann={ann!r}, train_imgs={imgs!r},
                    val_ann={ann!r}, val_imgs={imgs!r}),
    model=ModelConfig(img_size=128, anchors={anchors!r}))
"""


@pytest.mark.parametrize("anchors", ["default", "fitted"])
def test_autoanchor_prints_what_the_reference_prints(tmp_path, capsys,
                                                      anchors):
    """The v6.1 anchors (which the fit beats: the config-ready tuple is
    printed) and the fitted anchors themselves (which a refit with the
    same seed cannot beat: "do NOT beat"); both tools' stdout equal."""
    ann, imgs = build_coco_dataset(str(tmp_path), n_images=16, hw=(96, 128))
    args = ["--generations", "60", "--seed", "3"]
    cur = None
    if anchors == "fitted":
        wh = dataset_label_wh(COCODataset(ann, imgs), 128, seed=3)
        cur = fit_anchors(wh, seed=3, generations=60)[0]
    paths = {}
    for pkg in ("", "_torch"):
        paths[pkg] = str(tmp_path / f"cfg{pkg}.py")
        with open(paths[pkg], "w") as f:
            f.write(CONFIG.format(pkg=pkg, ann=ann, imgs=imgs, anchors=cur))
    tool = _jax_tool("autoanchor")
    tool.argparse = _parsing(["--config", paths[""], *args])
    tool.main()
    want = capsys.readouterr().out
    got = p_autoanchor.main(["--config", paths["_torch"], *args])
    assert capsys.readouterr().out == got == want
    if anchors == "fitted":
        assert "do NOT beat" in got
    else:
        assert "model.anchors = (" in got


# -- eval_ultralytics_weights -----------------------------------------------------

@pytest.fixture(scope="module")
def oracle_files(tmp_path_factory):
    """Four 48×64 COCO frames (letterboxed to 64² without a resize, so
    both packages calibrate on the same pixels) and a YOLOv5n ``.pt`` in
    the Ultralytics v6.1 layout, written by the JAX package's
    ``export_yolov5_state_dict`` and ``save_torch_state_dict`` from
    variables drawn from a numpy seed over ``jax.eval_shape`` of its
    model: BatchNorm statistics calibrated on noise through the port, the
    detect kernels scaled so that the logits have std LOGIT_STD on the
    frames."""
    root = str(tmp_path_factory.mktemp("oracle"))
    ann, imgs = build_coco_dataset(root, n_images=EVAL_FRAMES, hw=(48, 64),
                                   seed=5)
    jm = j_build_yolov5("n", 80)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, EVAL_SIZE, EVAL_SIZE, 3)),
        train=False))
    v = draw_variables(shapes, 7)
    pm = YOLOv5(80, jm.depth_multiple, jm.width_multiple).eval()
    pm.load_state_dict(from_jax_variables(v))
    calibrate_bn(pm, torch.Generator().manual_seed(7), size=EVAL_SIZE)
    sd = pm.state_dict()
    stat = {"mean": "running_mean", "var": "running_var"}
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, _: sd[".".join(k.key for k in p[:-1]) + "." +
                        stat[p[-1].key]].numpy(), v["batch_stats"])
    pm.load_state_dict(from_jax_variables(v))
    ds = COCODataset(ann, imgs)
    nb = np.zeros((0, 4), np.float32)
    x = torch.from_numpy(np.stack([
        letterbox_np(ds.load(i)["image"], nb, EVAL_SIZE)[0]
        for i in range(len(ds))]).astype(np.float32) / 255.0)
    with torch.no_grad():
        raw = pm(x)
    for i, r in enumerate(raw):
        k = v["params"][f"detect{i}"]["kernel"]
        v["params"][f"detect{i}"]["kernel"] = k * np.float32(
            LOGIT_STD / float(r.std()))
    weights = os.path.join(root, "yolov5n.pt")
    j_save(weights, j_export(v["params"], v["batch_stats"]))
    return weights, ann, imgs


def _argv(files, int8):
    weights, ann, imgs = files
    return (["--weights", weights, "--variant", "n", "--ann", ann,
             "--imgs", imgs, "--img-size", str(EVAL_SIZE), "--batch", "4"]
            + (["--int8", int8] if int8 else []))


@pytest.fixture(scope="module")
def reference_runs(oracle_files):
    """The JAX tool on the oracle files in float and in each int8 mode,
    each in its own thread and its own copy of the tool's module (its
    command line and its printed lines its own), started when the first
    eval test asks for them: XLA's compiles leave the interpreter lock to
    the port's runs meanwhile. Per mode a future of (stats, dets, the
    calibration statistics or None, the printed lines)."""
    made, amax = {}, {}
    j_calibrate = JQ.calibrate_amax

    class Recorded(JC.DetEval):
        def summarize(self):
            self.stats = super().summarize()
            made[threading.get_ident()] = self
            return self.stats

    def recorded(*a, **k):
        amax[threading.get_ident()] = j_calibrate(*a, **k)
        return amax[threading.get_ident()]

    def run(int8):
        me = threading.get_ident()
        amax.pop(me, None)
        tool = _jax_tool("eval_ultralytics_weights")
        lines = []
        tool.print = lambda *a: lines.extend(" ".join(map(str, a))
                                             .splitlines())
        tool.argparse = _parsing(_argv(oracle_files, int8))
        tool.main()
        return made[me].stats, _dets(made[me]), amax.get(me), lines

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "DetEval", Recorded)
        mp.setattr(JQ, "calibrate_amax", recorded)
        with ThreadPoolExecutor(3) as pool:
            yield {m: pool.submit(run, m) for m in (None, "layer", "flow")}


class _Recorded:
    """A DetEval class of ``module`` that keeps its instances;
    ``module.DetEval`` is swapped for it by the caller."""

    def __init__(self, module):
        made = self.made = []

        class Recorded(module.DetEval):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        self.cls = Recorded


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _dets(det_eval):
    """{(image, class): [(score, x, y, w, h), ...] by score}."""
    return {k: sorted((s, *np.asarray(b, np.float64)) for b, s in v)
            for k, v in det_eval._dts.items()}


def _assert_same_dets(got, want, box_tol, score_tol):
    assert set(got) == set(want)
    for key, w in want.items():
        g = list(got[key])
        assert len(g) == len(w), key
        for d in w:
            hit = [e for e in g if abs(e[0] - d[0]) <= score_tol
                   and max(abs(a - b) for a, b in zip(e[1:], d[1:]))
                   <= box_tol]
            assert hit, (key, d)
            g.remove(hit[0])


@pytest.mark.parametrize("int8", [None, "layer", "flow"])
def test_eval_ultralytics_weights_matches_reference(oracle_files,
                                                    reference_runs, int8,
                                                    monkeypatch, capsys):
    """The same ``.pt`` and frames through both tools (``--variant n
    --img-size 64 --batch 4``, the port's with ``--device cpu``): the
    stats and dets, in float and in each int8 mode; the port's closing
    lines equal the reference's."""
    reference = reference_runs[int8]
    p_rec = _Recorded(p_eval)
    monkeypatch.setattr(p_eval, "DetEval", p_rec.cls)
    own = []
    if int8:
        p_calibrate = PQ.calibrate_amax

        def reference_stats(model, batches, normalize=True):
            own.append(p_calibrate(model, batches, normalize=normalize))
            return reference.result()[2]

        monkeypatch.setattr(PQ, "calibrate_amax", reference_stats)
    # the port runs while the reference's thread compiles, and waits for
    # it only where it needs its statistics
    got = p_eval.main(_argv(oracle_files, int8) + ["--device", "cpu"])
    got_out = capsys.readouterr().out.splitlines()
    want, want_dets, amax, want_out = reference.result()
    assert len(p_rec.made) == 1
    if int8:
        assert len(own) == 1
        for path, w in _leaves(amax):
            np.testing.assert_allclose(_at(own[0], path), w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=str(path))
    want = {k: v for k, v in want.items()
            if k not in ("images_per_sec", "num_images")}
    assert set(want) < set(got) and "AP" in want
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    box_tol, score_tol = TOLS[int8]
    dets = _dets(p_rec.made[0])
    assert sum(map(len, dets.values())) > 0
    _assert_same_dets(dets, want_dets, box_tol, score_tol)
    if int8 is None:          # int8 stats may differ in their last digits
        assert got_out[-2:] == want_out[-2:]


def test_eval_ultralytics_weights_needs_cuda_without_device(oracle_files,
                                                            monkeypatch):
    """Without ``--device`` the tool asks for CUDA, and on a host without
    it raises rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_eval.main(_argv(oracle_files, None))
