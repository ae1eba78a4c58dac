"""The port's W8A8 int8 serving (ops/int8_conv.py, ops/quant.py, the int8
hooks of models/*, the int8 branches of engine/*) against the JAX
package's on the CPU. Inputs come from numpy seeds and go to both
packages; weights go through utils/convert.py:from_jax_variables and
quant trees through from_jax_quant_tree.

Tolerances, each with its reason:

* ``int8_conv2d`` and its plain version against ``lax.conv_general_dilated``
  on int8: exact (int32 sums of int8 products).
* ``_act_stats`` on one input: exact (the same sort, the same float32
  interpolation).
* Calibration statistics of a whole network: atol and rtol 1e-4, the
  float networks' own tolerance (tests/test_torch_port_model.py): their
  activations differ in the last bits of each conv's sums, and that grows
  with depth; the stem's input is identical and its statistics exact.
* Quant trees built from one set of statistics: ``w_q`` and ``w_f``
  exact, scales and biases within 1 ulp (the same numpy arithmetic in
  both packages; they come out equal). Built from each package's own
  calibration, per-layer ``w_q`` is still exact (it depends on the weights
  alone) and the scales are within the statistics' 1e-4.
* Raw head maps under one tree: 1e-5 of their largest (float32 rounding
  of the float parts; no int8 code flips on these inputs).
* ``run_eval`` with ``eval.int8`` on the fused route, which is the
  packed int8 serve step in both packages (the reference's
  ``make_packed_serve_step(quant=…)``, the port's packed network under
  ``attach_quant`` with the same fused postprocess as its
  ``make_packed_serve_step``): AP and AP50 within 1e-6, and the dets, as
  the COCO results JSON, the same multiset with boxes to 0.1 px and scores
  to 4e-3, tests/test_torch_port_serve.py's bounds for the bf16 candidate
  rows (64² frames need no resize, so both calibrate on the same pixels).
"""

import dataclasses
import functools
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from heltondetection_tpu.configs import base as j_base
from heltondetection_tpu.engine import runner as JR
from heltondetection_tpu.models import common as JC
from heltondetection_tpu.models import resnet as JRes
from heltondetection_tpu.ops import quant as JQ

import heltondetection_tpu_torch.models.cspdarknet as p_csp
from heltondetection_tpu_torch.configs import base as p_base
from heltondetection_tpu_torch.engine import runner as PR
from heltondetection_tpu_torch.models import common as PC
from heltondetection_tpu_torch.models import resnet as PRes
from heltondetection_tpu_torch.ops import quant as PQ
from heltondetection_tpu_torch.ops.int8_conv import (int8_conv2d,
                                                     int8_conv2d_plain)
from heltondetection_tpu_torch.utils.convert import (from_jax_quant_tree,
                                                     from_jax_variables)

from synth_data import build_coco_dataset
from torch_rcnn_refs import draw_variables
from test_torch_port_model import WIDTH, jax_variables, port_model

NC, SIZE, CONF = 4, 64, 0.05
NONE_SKIP = JQ.YOLO_INT8_SKIP_PRESETS["none"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _weights():
    """The tiny YOLOv5's flax model and seeded variables, drawn once
    (tests/test_torch_port_model.py's recipe); no test mutates them."""
    return jax_variables(nc=NC, seed=3, head_scale=0.25)


def _calib(seed, n=8, size=SIZE, c=3):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, c)).astype(np.uint8)


@pytest.fixture(scope="module")
def yolo(reference_evals):
    """One tiny YOLOv5 in both packages, each calibrated on the same four
    frames (the val set of ``reference_evals``; the reference's
    calibration started with the module), and the reference's layer and
    flow trees (stem float)."""
    jm, v, _, reference = reference_evals
    pm = port_model(v, NC)
    frames, ja = reference.result()
    pa = PQ.calibrate_amax(pm, [frames])
    trees = {"layer": JQ.build_quant_tree(v, ja, skip=NONE_SKIP),
             "flow": JQ.build_flow_tree(v, ja, skip=NONE_SKIP,
                                        float_out=JQ.YOLO_FLOW_FLOAT_OUT)}
    return dict(jm=jm, v=v, pm=pm, ja=ja, pa=pa, trees=trees)


def _reference_yolo(jm, v, img_dir):
    """The reference's side of the ``yolo`` fixture, run in a thread: the
    val frames of ``img_dir`` and its calibration statistics on them."""
    from heltondetection_tpu_torch.data.readers import imread_rgb
    frames = np.stack([imread_rgb(os.path.join(img_dir, f))
                       for f in sorted(os.listdir(img_dir))])
    return frames, JQ.calibrate_amax(jm, v, [frames])


def _draw(model, shape, seed):
    """Seeded variables of a flax ``model`` (``jax.eval_shape`` of its
    init, then numpy draws: BatchNorm scales and variances in [0.5, 1.5],
    means and biases N(0, 0.1²)), so the BN fold exercises every term."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros(shape), train=False))
    return jax.tree.map(jnp.asarray, draw_variables(shapes, seed))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_tree(yolo, mode, amax=None):
    amax = yolo["ja"] if amax is None else amax
    if mode == "layer":
        return PQ.build_quant_tree(yolo["pm"], amax, skip=NONE_SKIP)
    return PQ.build_flow_tree(yolo["pm"], amax, skip=NONE_SKIP,
                              float_out=PQ.YOLO_FLOW_FLOAT_OUT)


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
            continue
        g, w = got[k].numpy(), want[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (path, k)
        if g.dtype == np.int8 or k == "w_f":
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")
        else:
            np.testing.assert_array_max_ulp(g, w, 1)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


# -- the int8 product ----------------------------------------------------------

CONV_CASES = [
    # (B, Cin, H, W, Cout, k, stride, pad, groups)
    (2, 16, 9, 9, 24, 3, 1, 1, 1),
    (1, 8, 10, 10, 16, 3, 2, 1, 1),     # strided (YOLOv5's downsamples)
    (2, 8, 8, 8, 16, 3, 2, 1, 2),       # grouped, strided
    (3, 32, 5, 5, 12, 1, 2, 0, 4),      # grouped 1x1, Cout/group not 8k
    (2, 16, 7, 7, 8, 1, 1, 0, 1),       # 1x1: one GEMM over the rows
    (1, 3, 12, 12, 8, 6, 2, 2, 1),      # the 6x6 stem: K=108 zero padded
    (1, 8, 2, 2, 8, 3, 1, 1, 1),        # 4 rows: padded to the GEMM's 17
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_int8_conv2d_equals_jax_int8_conv(case):
    """``int8_conv2d`` (``_int_mm`` on an NHWC im2col, zero padded to its
    shape rules, one GEMM per group) and its float64 plain version equal
    the reference's int8 ``conv_general_dilated`` exactly."""
    b, cin, h, w, cout, k, s, p, g = case
    rng = np.random.default_rng(sum(case))
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    wk = rng.integers(-127, 128, (k, k, cin // g, cout)).astype(np.int8)
    dn = jax.lax.conv_dimension_numbers(x.shape, wk.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wk), (s, s), ((p, p), (p, p)),
        dimension_numbers=dn, feature_group_count=g,
        preferred_element_type=jnp.int32)).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(wk).permute(3, 2, 0, 1).contiguous()
    got = int8_conv2d(xt, wt, s, p, g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(int8_conv2d_plain(xt, wt, s, p, g).numpy(),
                                  want)


# -- calibration -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 8, 256, 256), (2, 64, 8, 8)])
def test_act_stats_equals_reference(shape):
    """Per-channel [amax, p999] on one input, exactly: the first shape's
    262,144 rows take the strided subsample (stride 2), in NHWC order."""
    rng = np.random.default_rng(shape[1])
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, 0, 0, 0] = 50.0                     # an outlier the p999 skips
    want = np.asarray(JC._act_stats(jnp.asarray(x.transpose(0, 2, 3, 1))))
    got = PC._act_stats(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_calibrate_amax_matches_reference(yolo):
    """The same tree of statistics (every conv's in and out, every
    residual sum), the stem's exactly, the rest within atol and rtol
    1e-4."""
    ja, pa = _np_tree(yolo["ja"]), yolo["pa"]
    want = dict(_leaves(ja))
    got = dict(_leaves(pa))
    assert set(got) == set(want)
    assert ("backbone", "c3_1", "m0", "res_amax") in got
    np.testing.assert_array_equal(got[("backbone", "stem", "in_amax")],
                                  want[("backbone", "stem", "in_amax")])
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4,
                                   err_msg=str(k))


# -- the quant trees ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["layer", "flow"])
def test_quant_trees_match_reference(yolo, mode):
    """From the reference's statistics the port builds the reference's
    tree, as ``from_jax_quant_tree`` carries it: every quantized path,
    ``w_q``/``w_f`` exact, scales and biases within 1 ulp. From its own
    statistics, the per-layer ``w_q`` are still exact."""
    want = from_jax_quant_tree(_np_tree(yolo["trees"][mode]))
    _assert_trees_equal(_port_tree(yolo, mode), want)
    own = _port_tree(yolo, mode, amax=yolo["pa"])
    for path, leaf in _leaves(want):
        node = own
        for k in path:
            node = node[k]
        if path[-1] in ("w_q", "w_f", "bias"):
            np.testing.assert_array_equal(node.numpy(), leaf.numpy())
        else:
            np.testing.assert_allclose(node.numpy(), leaf.numpy(),
                                       rtol=1e-4, err_msg=str(path))
    if mode == "flow":
        assert "res_scale" in want["backbone"]["c3_1"]["m0"]
        for name in ("td3", "bu4", "bu6"):
            assert "out_scale" not in want["neck"][name]["cv3"]


@pytest.mark.parametrize("mode", ["layer", "flow"])
def test_yolo_raw_maps_match_reference_int8(yolo, mode):
    """One tree, both packages: the int8 network's raw head maps within
    1e-5 of their largest (the flow folds done once on attach equal the
    reference's per-trace folds). The float model is left as it was."""
    jtree = yolo["trees"][mode]
    x = _calib(11, n=2).astype(np.float32) / 255.0
    want = jax.jit(lambda v, x: yolo["jm"].apply(v, x, train=False))(
        {**yolo["v"], "quant": jtree}, jnp.asarray(x))
    pm = yolo["pm"]
    qm = PQ.attach_quant(pm, from_jax_quant_tree(_np_tree(jtree)))
    assert not any(n.endswith("quant") for n, _ in pm.named_modules())
    with torch.no_grad():
        got = qm(torch.from_numpy(x))
        flt = pm(torch.from_numpy(x))
    for g, w, f in zip(got, want, flt):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
        assert not np.allclose(f.numpy(), w, atol=1e-3)   # it is int8


def test_flow_grouped_conv_fold_matches_reference():
    """A grouped conv in the int8 flow folds each group's slice of the
    incoming scales into its own output block (the reference's
    test_flow_grouped_conv_fold): the folded ``w_q`` equal to the
    reference's fold bit for bit, the outputs within 1e-5."""

    class JGrouped(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            x = JC.ConvBnAct(8, 1, name="a")(x, train)
            return JC.ConvBnAct(16, 3, groups=2, name="b")(x, train)

    class PGrouped(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = PC.ConvBnAct(4, 8, 1)
            self.b = PC.ConvBnAct(8, 16, 3, groups=2)

        def forward(self, x):                 # NHWC in, as the reference
            return self.b(self.a(x.permute(0, 3, 1, 2)))

    jm = JGrouped()
    v = _draw(jm, (1, 16, 16, 4), 40)
    pm = PGrouped().eval()
    pm.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, v)))
    calib = _calib(40, n=4, size=16, c=4)
    ja = JQ.calibrate_amax(jm, v, [calib])
    jt = JQ.build_flow_tree(v, ja)
    pt = PQ.build_flow_tree(pm, ja)
    _assert_trees_equal(pt, from_jax_quant_tree(_np_tree(jt)))
    x = _calib(41, n=2, size=16, c=4).astype(np.float32) / 255.0
    qm = PQ.attach_quant(pm, pt)
    with torch.no_grad():
        got = PC.q_dequant(qm(torch.from_numpy(x)))
    # the reference's fold (models/common.py _int8_flow) of b's weights
    # under a's output scales
    w_f, s_vec = np.asarray(jt["b"]["w_f"]), np.asarray(jt["a"]["out_scale"])
    kh, kw, cig, co = w_f.shape
    w_eff = (w_f.reshape(kh, kw, cig, 2, co // 2)
             * s_vec.reshape(2, cig).T[None, None, :, :, None]
             ).reshape(kh, kw, cig, co)
    s_w = np.max(np.abs(w_eff), axis=(0, 1, 2)) / np.float32(127.0)
    s_w = np.where(s_w > 0, s_w, np.float32(1.0))
    w_q = np.clip(np.round(w_eff / s_w), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(qm.b.quant.w_q.numpy(),
                                  w_q.transpose(3, 2, 0, 1))
    want = np.asarray(jax.jit(lambda v, x: JC.q_dequant(
        jm.apply(v, x, train=False)))({**v, "quant": jt}, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=0, atol=1e-5 * np.abs(want).max())


def _match_json_dets(got, want, box_tol=0.1, score_tol=4e-3):
    """Two COCO results lists: per image the same number of dets, each
    matched by category to one within the tolerances; returns the count."""
    n = 0
    for img in {d["image_id"] for d in want} | {d["image_id"] for d in got}:
        left = [d for d in want if d["image_id"] == img]
        mine = [d for d in got if d["image_id"] == img]
        assert len(mine) == len(left), img
        for d in mine:
            hit = [w for w in left if w["category_id"] == d["category_id"]
                   and np.abs(np.subtract(w["bbox"], d["bbox"])).max()
                   <= box_tol and abs(w["score"] - d["score"]) <= score_tol]
            assert hit, d
            left.remove(hit[0])
            n += 1
    return n


# -- ResNet pairs and FasterRCNN ---------------------------------------------------

def test_resnet_pair_quant_matches_reference():
    """The sibling conv/BN layout: the reference's flat ``convN_w_q``
    entries land nested under each conv, equal; the statistics are keyed
    as the reference keys them; the int8 block's output within 1e-5."""
    jm = JRes.Bottleneck(features=8, downsample=True)
    x = np.abs(np.random.default_rng(6).standard_normal(
        (2, 16, 16, 16))).astype(np.float32)
    v = _draw(jm, x.shape, 6)
    pm = PRes.Bottleneck(16, 8, 1, True).eval()
    pm.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, v)))
    xt = x.transpose(0, 3, 1, 2)
    ja = JQ.calibrate_amax(jm, v, [x], normalize=False)
    pa = PQ.calibrate_amax(pm, [xt], normalize=False)
    assert set(pa) == set(ja) == {f"{c}_in_amax" for c in
                                  ("conv1", "conv2", "conv3", "ds_conv")}
    for k in ja:
        np.testing.assert_allclose(pa[k], np.asarray(ja[k]), rtol=1e-4)
    jt = JQ.build_quant_tree(v, ja)
    pt = PQ.build_quant_tree(pm, ja)
    assert set(pt) == {"conv1", "conv2", "conv3", "ds_conv"}
    _assert_trees_equal(pt, from_jax_quant_tree(_np_tree(jt)))
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {**v, "quant": jt}, jnp.asarray(x)))
    with torch.no_grad():
        got = PQ.attach_quant(pm, pt)(torch.from_numpy(xt))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=0, atol=1e-5 * np.abs(want).max())


def test_quantize_rcnn_then_infer_matches_reference():
    """``quantize_rcnn`` of the small FasterRCNN (ResNet18, FPN): on its
    own statistics, the reference's ``build_quant_tree`` over the same
    variables builds the port's tree (the stem float, every backbone pair
    quantized; weights exact, scales within 1 ulp; the pairs' statistics
    and int8 forward are held against the reference's above), then
    ``faster_rcnn_infer`` under it keeps its det contract."""
    from torch_rcnn_refs import small_rcnn
    from heltondetection_tpu_torch.models.faster_rcnn import \
        faster_rcnn_infer
    jm, v, pm = small_rcnn()
    calib = _calib(7, n=4)
    pa = PQ.calibrate_amax(pm, [calib])
    pt = PQ.quantize_rcnn(pm, calib)
    bb = pt["backbone"]
    assert "stem_conv" not in bb and "conv1" in bb["layer1_0"]
    want = from_jax_quant_tree(_np_tree(JQ.build_quant_tree(
        v, pa, skip=("backbone/stem_conv",))))
    _assert_trees_equal(pt, want)
    x = torch.from_numpy(_calib(8, n=1).astype(np.float32) / 255.0)
    with torch.no_grad():
        dets = faster_rcnn_infer(PQ.attach_quant(pm, want), x)
    ob, _, oc, ov = dets
    assert ob.shape == (1, pm.cfg.max_det, 4) and torch.isfinite(ob).all()
    assert ((oc[ov] >= 0) & (oc[ov] < pm.cfg.num_classes)).all()


# -- the entry points ------------------------------------------------------------

@pytest.fixture()
def tiny_variant(monkeypatch):
    """Variant "t" (width 0.125) in both packages' variant tables."""
    from heltondetection_tpu.models import cspdarknet as j_csp
    for table in (j_csp.VARIANTS, p_csp.VARIANTS):
        monkeypatch.setitem(table, "t", (0.33, WIDTH))


def _configs(root, **test_kw):
    """The same experiment in both packages: a tiny YOLOv5 over four 64²
    synthetic COCO frames (no resize, so both calibrate on the same
    pixels)."""
    ann, imgs = build_coco_dataset(root, n_images=4, hw=(SIZE, SIZE),
                                   num_classes=NC)
    out = []
    for base in (j_base, p_base):
        out.append(base.ExperimentConfig(
            name="int8", work_dir=os.path.join(root, f"runs_{base.__name__}"),
            data=base.DataConfig(format="coco", train_ann=ann,
                                 train_imgs=imgs, val_ann=ann, val_imgs=imgs),
            model=base.ModelConfig(family="yolov5", variant="t",
                                   num_classes=NC, img_size=SIZE,
                                   dtype="float32"),
            train=base.TrainConfig(num_workers=0),
            eval=base.EvalConfig(batch_size=4, conf_thres=0.01, max_det=32,
                                 int8=True),
            test=base.TestConfig(int8_calib=4, **test_kw)))
    return out


@pytest.fixture(scope="module", autouse=True)
def reference_evals(tmp_path_factory):
    """Per int8 mode the experiment in both packages and the reference's
    ``run_eval`` of it with ``dump_json``, and the reference's side of the
    ``yolo`` fixture on its val frames, each started in a thread before the
    module's first test (XLA's compiles leave the interpreter lock to the
    other tests meanwhile)."""
    from heltondetection_tpu.models import cspdarknet as j_csp
    root = str(tmp_path_factory.mktemp("int8_eval"))
    with pytest.MonkeyPatch.context() as mp:
        for table in (j_csp.VARIANTS, p_csp.VARIANTS):
            mp.setitem(table, "t", (0.33, WIDTH))
        jm, v = _weights()
        pool = ThreadPoolExecutor(3)
        runs = {}
        for mode in ("layer", "flow"):
            jcfg, pcfg = _configs(os.path.join(root, mode), int8_mode=mode,
                                  int8_float_tail="none")
            path = os.path.join(root, mode, "reference.json")
            runs[mode] = (pcfg, path, pool.submit(
                JR.run_eval, jcfg, variables=v,
                model=JR.build_model(jcfg.model, NC), verbose=False,
                dump_json=path))
        reference = pool.submit(_reference_yolo, jm, v,
                                pcfg.data.val_imgs)
        yield jm, v, runs, reference
        pool.shutdown(wait=True)


@pytest.mark.parametrize("mode", ["layer", "flow"])
def test_run_eval_int8_matches_reference(reference_evals, tmp_path, mode,
                                         monkeypatch):
    """``run_eval`` with ``eval.int8`` (the "none" tail, so most convs run
    int8; the fused route, so the packed serve step under the tree): the
    port's AP, AP50 and dets equal the reference's on the same weights;
    the tree is cached beside the run, a second call loads it without
    calibrating, the in-training eval ignores int8 (float), and
    ``run_test`` with ``test.int8`` finds ``load_detector``'s int8 dets
    through the same cache.

    The layer mode calibrates in each package. The flow mode's port run
    calibrates with the reference's statistics swapped in: the two
    packages' statistics differ by up to 1e-4 (above), which in the flow
    mode moves an int8 code now and then (every conv requantizes its
    output), and these random, saturating weights amplify one moved code
    into other dets on one of the four frames."""
    jm, v, runs, reference = reference_evals
    pcfg, jpath, fut = runs[mode]
    if mode == "flow":
        frames, ja = reference.result()

        def reference_stats(model, batches, normalize=True):
            # the val frames, letterboxed without a resize: the reference's
            # statistics of them, computed with the module's start
            assert normalize and np.array_equal(np.concatenate(
                [np.asarray(b) for b in batches]), frames)
            return ja

        monkeypatch.setattr(PQ, "calibrate_amax", reference_stats)
    ppath = str(tmp_path / "p.json")
    sd = from_jax_variables(v)
    got = PR.run_eval(pcfg, sd, verbose=False, device="cpu",
                      dump_json=ppath)
    want = fut.result()
    for k in ("AP", "AP50"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    with open(jpath) as f, open(ppath) as g:
        assert _match_json_dets(json.load(g), json.load(f)) > 0
    assert os.path.exists(os.path.join(pcfg.work_dir, "int8",
                                       "int8_quant.npz"))
    calls = []
    monkeypatch.setattr(PQ, "calibrate_amax",
                        lambda *a, **k: calls.append(1))
    again = PR.run_eval(pcfg, sd, verbose=False, device="cpu")
    assert calls == [] and again["AP"] == got["AP"]
    reuse = {}
    flt = PR.run_eval(pcfg, sd, verbose=False, device="cpu", _reuse=reuse)
    assert reuse["int8_note"] and calls == []
    assert "AP" in flt
    # --mode test with test.int8 on a val image: the cached tree's dets,
    # those of load_detector(int8=True) on the same frame
    from heltondetection_tpu_torch.data.readers import imread_rgb
    from heltondetection_tpu_torch.utils.ckpt import save_eval_variables
    save_eval_variables(pcfg.ckpt_dir, sd, 1)
    tcfg = dataclasses.replace(pcfg, test=dataclasses.replace(
        pcfg.test, int8=True, conf_thres=0.05))
    image = os.path.join(pcfg.data.val_imgs, "img_0000.png")
    tested = PR.run_test(tcfg, image, device="cpu")
    want = PR.load_detector(tcfg, device="cpu").detect_image(
        imread_rgb(image))
    assert calls == [] and len(want[1]) > 0
    for k, w in zip(("boxes", "scores", "classes"), want):
        np.testing.assert_array_equal(tested[k], w)


def test_int8_cache_keys_the_skip_list(tiny_variant, tmp_path):
    """Two explicit ``int8_skip`` lists of one length key two caches (the
    reference keys them by their length only and would hand the second
    the first's tree); the same list reloads."""
    _, pcfg = _configs(str(tmp_path))
    jm, v = _weights()
    model = PR.build_model(pcfg.model, NC)
    model.load_state_dict(from_jax_variables(v))

    def tree(skip):
        cfg = dataclasses.replace(pcfg, test=dataclasses.replace(
            pcfg.test, int8_skip=skip))
        return PR._int8_quant_tree(cfg, model)

    a = tree(("neck/lat4",))
    b = tree(("neck/lat5",))
    assert "lat4" not in a["neck"] and "lat5" in a["neck"]
    assert "lat5" not in b["neck"] and "lat4" in b["neck"]
    c = tree(("neck/lat5",))
    assert dict(_leaves(c)).keys() == dict(_leaves(b)).keys()


def test_int8_knobs_validate_and_presets_match(tiny_variant, tmp_path):
    """``int8_mode``, ``int8_float_tail`` and ``int8_act_clip`` values the
    reference refuses raise ``ValueError`` naming the knob; the presets
    and head-boundary paths are the reference's; each preset's tree keeps
    its paths float; without a val set or a calibration directory int8
    raises."""
    assert PQ.YOLO_INT8_SKIP_PRESETS == JQ.YOLO_INT8_SKIP_PRESETS
    assert PQ.YOLO_FLOW_FLOAT_OUT == JQ.YOLO_FLOW_FLOAT_OUT
    _, pcfg = _configs(str(tmp_path))
    model = PR.build_model(pcfg.model, NC)
    model.load_state_dict(from_jax_variables(_weights()[1]))

    def with_test(**kw):
        return dataclasses.replace(pcfg, test=dataclasses.replace(
            pcfg.test, **kw), name="_".join(f"{k}{v}" for k, v in kw.items()))

    for kw, knob in ((dict(int8_mode="Flow"), "int8_mode"),
                     (dict(int8_float_tail="fastest"), "int8_float_tail"),
                     (dict(int8_act_clip="max"), "int8_act_clip")):
        with pytest.raises(ValueError, match=knob):
            PR._int8_quant_tree(with_test(**kw), model)
    q = PR._int8_quant_tree(with_test(int8_float_tail="balanced"), model)
    assert "down1" not in q["backbone"] and "td3" not in q["neck"]
    assert "down2" in q["backbone"] and "bu4" in q["neck"]
    q = PR._int8_quant_tree(with_test(int8_float_tail="accuracy"), model)
    assert "down2" not in q["backbone"] and "td4" not in q["neck"]
    assert "down3" in q["backbone"]
    nodata = dataclasses.replace(pcfg, data=p_base.DataConfig())
    with pytest.raises(ValueError, match="int8_calib_dir"):
        PR._int8_quant_tree(nodata, model)


def test_q_cat_channel_axis_and_float_fallback():
    """``q_cat`` concatenates QT parts on the channel axis only (1 or −3
    in NCHW), raising on any other; a float part demotes the concat to
    float. A tree without an entry for a conv (never calibrated, or stats
    of zero) leaves it float, and an empty tree gives the float model's
    outputs bit for bit."""
    a = PC.QT(torch.zeros((1, 3, 4, 4), dtype=torch.int8), torch.ones(3))
    b = PC.QT(torch.ones((1, 5, 4, 4), dtype=torch.int8), torch.ones(5))
    for dim in (1, -3):
        out = PC.q_cat([a, b], dim=dim)
        assert out.i8.shape == (1, 8, 4, 4) and out.scale.shape == (8,)
    with pytest.raises(ValueError):
        PC.q_cat([a, a], dim=2)
    mixed = PC.q_cat([a, torch.ones((1, 2, 4, 4))])
    assert not isinstance(mixed, PC.QT) and mixed.shape == (1, 5, 4, 4)

    pm = port_model(_weights()[1], NC)
    amax = PQ.calibrate_amax(pm, [_calib(3, n=2)])
    amax["backbone"].pop("down1")
    amax["backbone"]["down2"]["in_amax"] = np.zeros_like(
        amax["backbone"]["down2"]["in_amax"])
    tree = PQ.build_quant_tree(pm, amax, skip=NONE_SKIP)
    assert "down1" not in tree["backbone"] and \
        "down2" not in tree["backbone"] and "down3" in tree["backbone"]
    x = torch.from_numpy(_calib(4, n=1).astype(np.float32) / 255.0)
    with torch.no_grad():
        for f, g in zip(pm(x), PQ.attach_quant(pm, {})(x)):
            assert torch.equal(f, g)


def test_rcnn_int8_entry_points(tmp_path):
    """FasterRCNN under int8 through the port's entry points: ``run_eval``
    with ``eval.int8`` (its tree cached beside the run),
    ``load_detector`` of a checkpoint with ``test.int8`` equal to a
    ``Detector`` over ``forward_for_eval(quant=…)`` of that cached tree,
    a ``BatchingDetector`` over it with the Detector's dets at its bucket,
    and ``run_test`` of an image file with the same dets. One calibration
    serves them all through the cache."""
    import cv2
    from torch_rcnn_refs import SMALL_CFG, port_small_rcnn, small_rcnn
    from heltondetection_tpu_torch.engine.infer import Detector
    from heltondetection_tpu_torch.engine.serve import BatchingDetector
    from heltondetection_tpu_torch.utils.ckpt import save_eval_variables
    _, v, _ = small_rcnn()
    ann, imgs = build_coco_dataset(str(tmp_path), n_images=4,
                                   hw=(SIZE, SIZE), num_classes=NC)
    cfg = p_base.ExperimentConfig(
        name="rcnn_int8", work_dir=str(tmp_path / "runs"),
        data=p_base.DataConfig(format="coco", train_ann=ann,
                               train_imgs=imgs, val_ann=ann, val_imgs=imgs),
        model=p_base.ModelConfig(family="faster_rcnn", dtype="float32",
                                 **SMALL_CFG),
        train=p_base.TrainConfig(num_workers=0),
        eval=p_base.EvalConfig(batch_size=2, conf_thres=0.05, max_det=100,
                               int8=True),
        test=p_base.TestConfig(conf_thres=0.05, int8=True, int8_calib=4))
    model = port_small_rcnn(v)
    sd = model.state_dict()
    stats = PR.run_eval(cfg, sd, verbose=False, device="cpu")
    assert np.isfinite(stats["AP"])
    save_eval_variables(cfg.ckpt_dir, sd, 1)
    calls = []
    real = PQ.calibrate_amax
    PQ.calibrate_amax = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        det = PR.load_detector(cfg, device="cpu")
        by_hand = Detector(None, NC, SIZE, forward_fn=PR.forward_for_eval(
            model, NC, device="cpu", quant=PR._int8_quant_tree(cfg, model)),
            conf_thres=cfg.test.conf_thres, iou_thres=cfg.test.iou_thres,
            device="cpu")
        rng = np.random.default_rng(9)
        frames = [rng.integers(0, 256, hw + (3,)).astype(np.uint8)
                  for hw in ((96, 128), (SIZE, SIZE))]
        got = det.detect_batch(frames)
        assert sum(len(s) for _, s, _ in got) > 0
        for g, w in zip(got, by_hand.detect_batch(frames)):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        with BatchingDetector(det, batch_size=2, batch_buckets=(2,)) as bd:
            served = bd.detect(frames[1], timeout=60)
        xb, metas = det._letterbox([frames[1], frames[1]], SIZE)
        o = [t[0].numpy() for t in det._detect(xb)]
        for a, b in zip(served, det._to_source(*o, metas[0],
                                               frames[1].shape[:2])):
            np.testing.assert_array_equal(a, b)
        path = str(tmp_path / "frame.png")
        cv2.imwrite(path, frames[0][..., ::-1])
        tested = PR.run_test(cfg, path, device="cpu")
        for k, want in zip(("boxes", "scores", "classes"),
                           det.detect_image(frames[0])):
            np.testing.assert_array_equal(tested[k], want)
    finally:
        PQ.calibrate_amax = real
    assert calls == []


def test_port_sources_state_no_tpu_rates():
    """The port states no time, rate or ratio taken on a TPU: no line of
    its sources (nor chip_smoke.py) puts a rate or a speed-up within two
    lines of a TPU's name (v5e, v5l, TPU, MXU), as the int8 knobs'
    comments once did ("v5l 640² b128 … bf16 1154 img/s", "the MXU's 2x
    int8 path")."""
    import pathlib
    import re
    root = pathlib.Path(__file__).resolve().parent.parent
    rate = re.compile(r"\d[\d,.]*\s*(img/s|TOP/?s|TFLOP|GB/s|TB/s)|"
                      r"\d(\.\d+)?\s*[x×](?!\w)")
    tpu = re.compile(r"\b(v5e|v5l|v5p|v4|TPU|MXU)\b")
    files = [p for p in (root / "heltondetection_tpu_torch").rglob("*")
             if p.suffix in (".py", ".cu", ".cuh", ".cpp")]
    files.append(root / "chip_smoke.py")
    bad = []
    for path in files:
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if rate.search(line) and tpu.search(
                    "\n".join(lines[max(0, i - 2):i + 3])):
                bad.append(f"{path.relative_to(root)}:{i + 1}: {line}")
    assert not bad, "\n".join(bad)
