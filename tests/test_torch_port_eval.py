"""The port's eval slice against the JAX package on the CPU: DetEval, the
candidate selection and postprocess, batched_nms, the plain versions of the
nms_mask and iou_matrix kernels, the Evaluator on both routes and the
forward_fn route of Detector. Inputs come from numpy seeds and go to both
packages; weights go through utils/convert.py:from_jax_variables.

Tolerances, each with its reason:

* DetEval stats: 1e-12. Both sides run the same float64 numpy arithmetic
  on the same inputs.
* Candidates, postprocess and batched_nms on identical inputs: boxes,
  classes and masks exact (they are gathered, never computed); scores to
  1e-6 (obj·cls is one float32 product on both sides). The random inputs
  hold no ties and no IoU sitting on the threshold, so the NMS predicates
  in use (``inter > thr·union`` here and in the Pallas kernels,
  ``inter/union > thr`` in the reference's XLA paths) agree.
* iou_matrix against the Pallas kernel: 1e-5, as tests/test_boxes.py.
* Evaluator on painted maps: 1e-9; the decoded boxes differ from JAX's
  only in the last bits of σ.
* Evaluator on a tiny YOLOv5: 1e-6 on both routes. The raw maps agree to
  1e-4, and on these frames no det changes rank or match; the stats came
  out equal. (On the packed route a bf16 candidate row that rounds the
  other way could move a det by up to 0.1 px and 4e-3 in score,
  tests/test_torch_port_serve.py.)
* Detector(forward_fn): the same det multiset, boxes to 0.05 px and
  scores to 2.5e-5, the bounds of decode_full in
  tests/test_torch_port_model.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from heltondetection_tpu.engine import evaluator as JE
from heltondetection_tpu.engine.infer import Detector as JDetector
from heltondetection_tpu.models.yolov5 import decode_full as j_decode_full
from heltondetection_tpu.ops import boxes as JB
from heltondetection_tpu.ops import nms as JN
from heltondetection_tpu.utils import cocoeval as JC

from heltondetection_tpu_torch.engine import evaluator as TE
from heltondetection_tpu_torch.engine.infer import Detector
from heltondetection_tpu_torch.engine.runner import forward_for_eval
from heltondetection_tpu_torch.kernels import iou as iou_kernel
from heltondetection_tpu_torch.kernels import launch_counts
from heltondetection_tpu_torch.kernels import nms as nms_kernel
from heltondetection_tpu_torch.models.yolov5 import decode_full
from heltondetection_tpu_torch.ops import boxes as TB
from heltondetection_tpu_torch.ops import nms as TN
from heltondetection_tpu_torch.utils import cocoeval as TC

from test_evaluator import synth_raw_maps
from test_torch_port_model import jax_variables, port_model

NC, SIZE, CONF, IOU, TOPK = 4, 96, 0.3, 0.65, 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """(flax model, its variables, the port's model) on one set of weights,
    head scaled to 0.25 so that scores spread over (0, 1)."""
    jmodel, variables = jax_variables(nc=NC, seed=3, head_scale=0.25)
    return jmodel, variables, port_model(variables, NC)


def _boxes(rng, shape, size=100.0, lo=4.0, hi=40.0):
    xy = rng.uniform(0, size, shape + (2,))
    wh = rng.uniform(lo, hi, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _candidates(seed, b=2, n=300, c=5):
    """Random (boxes, obj, cls) with continuous scores: no ties."""
    rng = np.random.default_rng(seed)
    return (_boxes(rng, (b, n), size=60.0),
            rng.uniform(0, 1, (b, n)).astype(np.float32),
            rng.uniform(0, 1, (b, n, c)).astype(np.float32))


def _assert_dets_equal(got, want):
    """Boxes, classes and valid exact; scores to 1e-6."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, i
        if i == 1:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(g, w)


# -- DetEval -----------------------------------------------------------------

def _fill(ev, seed, with_gt=True):
    """Seeded gt and dets over 6 images and 4 classes: boxes of every area
    range, crowd and ignore gts, an image with dets only and one with gt
    only, and dets jittered around the gts plus false positives.
    ``with_gt=False`` adds the dets only."""
    rng = np.random.default_rng(seed)
    for img in range(6):
        n_gt = 0 if img == 5 else int(rng.integers(1, 8))
        wh = rng.choice([12.0, 60.0, 150.0], (n_gt, 1)) * \
            rng.uniform(0.7, 1.3, (n_gt, 2))
        gt = np.concatenate([rng.uniform(0, 300, (n_gt, 2)), wh], 1)
        gcls = rng.integers(0, 4, n_gt)
        crowd = (rng.uniform(size=n_gt) < 0.15).astype(int)
        ignore = (rng.uniform(size=n_gt) < 0.1).astype(int)
        if n_gt and with_gt:
            ev.add_gt(f"im{img}", gt, gcls, iscrowd=crowd, ignore=ignore)
        if img == 4:
            continue
        jit = gt + rng.normal(0, 3, gt.shape)
        jit[:, 2:] = np.abs(jit[:, 2:]) + 1
        n_fp = int(rng.integers(0, 6))
        fp = np.concatenate([rng.uniform(0, 300, (n_fp, 2)),
                             rng.uniform(5, 120, (n_fp, 2))], 1)
        dets = np.concatenate([jit, fp])
        dcls = np.concatenate([gcls, rng.integers(0, 4, n_fp)])
        keep = rng.uniform(size=len(dets)) < 0.85
        ev.add_det(f"im{img}", dets[keep], rng.uniform(0.01, 1, keep.sum()),
                   dcls[keep])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deteval_matches_jax(seed):
    """The port's DetEval summarizes as the JAX DetEval does, to 1e-12.
    reset_dets keeps the gt, and summarize after it scores the new dets
    (the reference returns the stats of its first summarize there)."""
    want, got = JC.DetEval(4), TC.DetEval(4)
    _fill(want, seed)
    _fill(got, seed)
    ws, gs = want.summarize(), got.summarize()
    assert ws.keys() == gs.keys()
    for k in ws:
        assert abs(gs[k] - ws[k]) <= 1e-12, (k, gs[k], ws[k])
    assert 0.05 < gs["AP"] < 0.95
    assert TC.format_summary(gs) == JC.format_summary(ws)
    got.reset_dets()
    assert got.summarize()["AP"] == 0.0
    _fill(got, seed, with_gt=False)
    assert got.summarize() == gs


# -- candidates, postprocess, batched_nms ------------------------------------

@pytest.mark.parametrize("n,topk,max_cls", [(300, 64, 4), (100, 512, 4),
                                             (300, 128, 1)],
                         ids=["truncate", "pad", "one-class"])
def test_multilabel_candidates_matches_jax(n, topk, max_cls):
    """topk 64 truncates stage 1 (300 boxes); 512 over 100 boxes pads
    (k2 = 400 pairs) with class −1 rows; the last keeps one class per
    box."""
    boxes, obj, cls = _candidates(7, n=n)
    kw = dict(topk=topk, conf_thres=0.2, max_cls_per_box=max_cls)
    want = jax.jit(jax.vmap(lambda b, o, c: JE.multilabel_candidates(
        b, o, c, **kw)))(jnp.asarray(boxes), jnp.asarray(obj),
                         jnp.asarray(cls))
    got = TE.multilabel_candidates(torch.from_numpy(boxes),
                                   torch.from_numpy(obj),
                                   torch.from_numpy(cls), **kw)
    assert got[0].shape == (2, topk, 4)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 1:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if topk == 512:
        assert (got[2][:, 400:] == -1).all() and (got[1][:, 400:] == 0).all()


@pytest.mark.parametrize("multi_label", [True, False])
def test_make_postprocess_matches_jax(multi_label):
    boxes, obj, cls = _candidates(8)
    kw = dict(conf_thres=0.05, iou_thres=0.5, pre_nms_topk=256, max_det=300,
              multi_label=multi_label)
    want = jax.jit(JE.make_postprocess(5, **kw))(
        jnp.asarray(boxes), jnp.asarray(obj), jnp.asarray(cls))
    before = dict(launch_counts)
    got = TE.make_postprocess(5, **kw)(torch.from_numpy(boxes),
                                       torch.from_numpy(obj),
                                       torch.from_numpy(cls))
    assert launch_counts == before
    _assert_dets_equal(got, want)
    no_nms = TE.make_postprocess(5, **dict(kw, iou_thres=1.01))(
        torch.from_numpy(boxes), torch.from_numpy(obj),
        torch.from_numpy(cls))
    assert (0 < got[3].sum(1)).all()
    assert (got[3].sum(1) < no_nms[3].sum(1)).all()      # NMS removed some


BNMS_CASES = {
    "k-not-128": dict(n=200, kw=dict(pre_nms_topk=1024, max_det=200)),
    "k-below-max-det": dict(n=60, kw=dict(pre_nms_topk=1024, max_det=100)),
    "class-agnostic": dict(n=300, kw=dict(pre_nms_topk=256, max_det=256,
                                          class_aware=False)),
}


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas-interpret", "xla"])
@pytest.mark.parametrize("case", list(BNMS_CASES))
def test_batched_nms_matches_jax(case, use_pallas):
    """The port's batched_nms (plain CPU route, no launch) against the JAX
    batched_nms run per image, through nms_mask_pallas in interpret mode
    and through the XLA fixpoint."""
    n, kw = BNMS_CASES[case]["n"], BNMS_CASES[case]["kw"]
    rng = np.random.default_rng(9)
    boxes = _boxes(rng, (2, n), size=60.0)
    scores = rng.uniform(0, 1, (2, n)).astype(np.float32)
    classes = rng.integers(0, 3, (2, n)).astype(np.int32)
    kw = dict(iou_thres=0.5, score_thres=0.1, **kw)
    fn = jax.jit(jax.vmap(lambda b, s, c: JN.batched_nms(
        b, s, c, use_pallas=use_pallas, **kw)))
    with pltpu.force_tpu_interpret_mode():
        want = fn(jnp.asarray(boxes), jnp.asarray(scores),
                  jnp.asarray(classes))
    before = dict(launch_counts)
    got = TN.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(classes), **kw)
    assert launch_counts == before
    _assert_dets_equal(got, want)
    no_nms = TN.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(classes),
                            **dict(kw, iou_thres=1.01))
    assert (0 < got[3].sum(1)).all()
    assert (got[3].sum(1) < no_nms[3].sum(1)).all()      # NMS removed some


def _chain(n):
    """Alternating suppression chain: iou(i, i+1) = 8/12 > 0.65."""
    i = np.arange(n, dtype=np.float32)
    return np.stack([i * 2.0, np.zeros(n), i * 2.0 + 10.0,
                     np.full(n, 10.0)], -1).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "chain", "padding"])
def test_nms_mask_plain_matches_pallas(case):
    """B2's plain version, nms_mask_seq batched (and nms_mask_batched on
    CPU tensors), equals nms_mask_pallas in interpret mode; the chain is
    128 deep, past any 32-step cap."""
    rng = np.random.default_rng(10)
    if case == "random":
        batch, thr = _boxes(rng, (2, 128), size=100.0), 0.5
    elif case == "chain":
        batch, thr = _chain(128)[None], 0.65
    else:
        batch = _boxes(rng, (2, 256), size=60.0)
        batch += rng.integers(0, 3, (2, 256, 1)).astype(np.float32) * 8192.0
        batch[:, 200:] = 0.0
        thr = 0.45
    with pltpu.force_tpu_interpret_mode():
        want = np.stack([np.asarray(JN.nms_mask_pallas(
            jnp.asarray(b), None, iou_thres=thr)) for b in batch])
    t = torch.from_numpy(batch)
    before = dict(launch_counts)
    np.testing.assert_array_equal(TN.nms_mask_seq(t, thr).numpy(), want)
    np.testing.assert_array_equal(TN.nms_mask_batched(t, thr).numpy(), want)
    assert launch_counts == before
    if case == "chain":
        assert want.sum() == 64


def test_iou_matrix_op_matches_pallas():
    """ops.boxes.iou_matrix on CPU tensors (B3's plain version) against
    iou_matrix_pallas in interpret mode at (64, 256), to 1e-5, with a
    zero-area row giving zeros; and at a ragged (37, 53) equal to
    box_iou_matrix, which the Pallas kernel cannot take."""
    rng = np.random.default_rng(0)
    a = _boxes(rng, (64,), size=64.0, lo=1.0, hi=30.0)
    b = _boxes(rng, (256,), size=64.0, lo=1.0, hi=30.0)
    a[5] = 0
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JB.iou_matrix_pallas(jnp.asarray(a), jnp.asarray(b),
                                               tile_n=32, tile_m=128))
    before = dict(launch_counts)
    got = TB.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert launch_counts == before
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (got[5] == 0).all()
    a2, b2 = torch.from_numpy(a[:37]), torch.from_numpy(b[:53])
    torch.testing.assert_close(TB.iou_matrix(a2, b2),
                               TB.box_iou_matrix(a2, b2), atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["nms-cpu", "nms-float64", "nms-n-not-64",
                                 "iou-cpu", "iou-float64", "iou-shape"])
def test_kernel_wrappers_reject_what_they_cannot_run(bad):
    """The CUDA wrappers take only what their kernels take and raise on
    anything else, before building or launching."""
    boxes = torch.zeros((1, 128, 4))
    call = {
        "nms-cpu": lambda: nms_kernel.nms_mask(boxes, 0.5),
        "nms-float64": lambda: nms_kernel.nms_mask(boxes.double(), 0.5),
        "nms-n-not-64": lambda: nms_kernel.nms_mask(boxes[:, :96], 0.5),
        "iou-cpu": lambda: iou_kernel.iou_matrix(boxes[0], boxes[0]),
        "iou-float64": lambda: iou_kernel.iou_matrix(boxes[0].double(),
                                                     boxes[0]),
        "iou-shape": lambda: iou_kernel.iou_matrix(boxes, boxes[0]),
    }[bad]
    before = dict(launch_counts)
    with pytest.raises(ValueError):
        call()
    assert launch_counts == before


# -- Evaluator ---------------------------------------------------------------

def _painted_batch(scale, px, orig_hw, size=64):
    return {"image": np.zeros((1, size, size, 3), np.uint8),
            "img_id": ["img0"], "scale": [scale], "pad_x": [px],
            "pad_y": [0.0], "orig_hw": [orig_hw]}


@pytest.mark.parametrize("case", ["identity", "letterbox"])
def test_evaluator_painted_maps_match_jax(case):
    """The two cases of tests/test_evaluator.py through both Evaluators:
    AP > 0.99 and equal stats; the letterbox case is a 128x96 source at
    scale 0.5, pad_x 8."""
    nc = 8
    gts = [(20.0, 20.0, 12.0, 16.0), (44.0, 40.0, 30.0, 24.0),
           (32.0, 52.0, 8.0, 8.0)]
    classes = [0, 3, 5]
    scale, px, hw = (1.0, 0.0, (64, 64)) if case == "identity" else \
        (0.5, 8.0, (128, 96))
    raws = synth_raw_maps(gts, classes, 64, nc)
    xywh = []
    for cx, cy, w, h in gts:
        x1 = np.clip((cx - w / 2 - px) / scale, 0, hw[1])
        y1 = np.clip((cy - h / 2) / scale, 0, hw[0])
        x2 = np.clip((cx + w / 2 - px) / scale, 0, hw[1])
        y2 = np.clip((cy + h / 2) / scale, 0, hw[0])
        xywh.append((x1, y1, x2 - x1, y2 - y1))
    kw = dict(conf_thres=0.1, pre_nms_topk=128, max_det=32)
    jev = JC.DetEval(nc)
    jev.add_gt("img0", xywh, classes)
    want = JE.Evaluator(lambda images: j_decode_full(raws, nc), nc,
                        **kw).run([_painted_batch(scale, px, hw)], jev)
    traws = [torch.from_numpy(np.array(r)) for r in raws]
    tev = TC.DetEval(nc)
    tev.add_gt("img0", xywh, classes)
    got = TE.Evaluator(lambda images: decode_full(traws, nc), nc,
                       device="cpu", **kw).run(
        [_painted_batch(scale, px, hw)], tev)
    assert got["AP"] > 0.99 and got["AP50"] > 0.99
    for k in TC.DetEval(nc).summarize():
        assert abs(got[k] - want[k]) <= 1e-9, k
    assert got["num_images"] == 1


def _noise_batches():
    """Three noise frames at SIZE² in batches of two, the last padded with
    an ``img_id`` of None (SIZE² sources: the letterbox is the identity)."""
    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, (4, SIZE, SIZE, 3)).astype(np.uint8)
    return [{"image": imgs[i:i + 2], "img_id": ids,
             "scale": [1.0, 1.0], "pad_x": [0.0, 0.0],
             "pad_y": [0.0, 0.0], "orig_hw": [(SIZE, SIZE)] * 2}
            for i, ids in ((0, [0, 1]), (2, [2, None]))]


def _gts_near(step, batches):
    """Gt that the dets can match: the first six dets of ``step`` on each
    image, clipped to the frame as the letterbox inverse clips dets and
    jittered by 1.5 px (seeded), with one class in four changed."""
    rng = np.random.default_rng(14)
    gts = []
    for batch in batches:
        ob, _, oc, ov = (t.numpy() for t in step(batch["image"])[0])
        for i, img in enumerate(batch["img_id"]):
            if img is None:
                continue
            b, c = ob[i][ov[i]][:6], oc[i][ov[i]][:6].copy()
            b = np.clip(b + rng.normal(0, 1.5, b.shape), 0, SIZE)
            flip = rng.uniform(size=len(c)) < 0.25
            c[flip] = (c[flip] + 1) % NC
            gts.append((img, np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]],
                                            1), c))
    return gts


def _with_gt(ev, gts):
    for img, xywh, cls in gts:
        ev.add_gt(img, xywh, cls)
    return ev


@pytest.mark.parametrize("route", ["decode_full", "packed"])
def test_evaluator_tiny_yolov5_matches_jax(weights, route):
    """A tiny YOLOv5 through both Evaluators on the same weights and frames,
    on the decode_full route (forward_for_eval + make_postprocess) and on
    the packed step_fn route; the padding row of the last batch is
    skipped. Stats to 1e-6."""
    jmodel, variables, pmodel = weights
    batches = _noise_batches()
    kw = dict(conf_thres=CONF, iou_thres=IOU, pre_nms_topk=TOPK, max_det=100)
    if route == "decode_full":
        def jfwd(images):
            x = jnp.asarray(images, jnp.float32) / 255.0
            return j_decode_full(jmodel.apply(variables, x, train=False), NC)
        jev = JE.Evaluator(jfwd, NC, **kw)
        tev = TE.Evaluator(forward_for_eval(pmodel, NC, device="cpu"), NC,
                           device="cpu", **kw)
    else:
        jev = JE.Evaluator(None, NC, step_fn=JE.make_packed_serve_step(
            jmodel, variables, NC, **kw))
        tev = TE.Evaluator(None, NC, device="cpu",
                           step_fn=TE.make_packed_serve_step(
                               pmodel, NC, device="cpu", **kw))
    gts = _gts_near(tev._dispatch, batches)
    want = jev.run(batches, _with_gt(JC.DetEval(NC), gts))
    before = dict(launch_counts)
    got = tev.run(batches, _with_gt(TC.DetEval(NC), gts))
    assert launch_counts == before
    assert got["num_images"] == want["num_images"] == 3
    assert 0.1 < got["AP"] < 0.9
    for k in TC.DetEval(NC).summarize():
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def _assert_same_dets(got, want, box_tol=0.05, score_tol=2.5e-5):
    """The same det multiset: each det pairs one to one with the nearest
    det of its class, within the bounds."""
    gb, gs, gc = got
    wb, ws, wc = want
    assert len(gs) == len(ws) > 0
    assert sorted(gc.tolist()) == sorted(wc.tolist())
    db = np.abs(gb[:, None, :] - wb[None, :, :]).max(-1)
    ds = np.abs(gs[:, None] - ws[None, :])
    dist = np.maximum(db / box_tol, ds / score_tol)
    dist[gc[:, None] != wc[None, :]] = np.inf
    match = dist.argmin(1)
    assert len(set(match.tolist())) == len(match)
    assert dist[np.arange(len(match)), match].max() <= 1.0


def test_detector_forward_fn_matches_jax(weights):
    """The forward_fn route of Detector (single-label make_postprocess at
    conf 0.25, iou 0.45, max_det 300) against the JAX Detector(forward_fn)
    on mixed-size frames, in source coordinates."""
    jmodel, variables, pmodel = weights

    def jfwd(images):
        x = jnp.asarray(images, jnp.float32) / 255.0
        return j_decode_full(jmodel.apply(variables, x, train=False), NC)

    rng = np.random.default_rng(13)
    frames = [rng.integers(0, 256, hw + (3,)).astype(np.uint8)
              for hw in ((72, SIZE), (SIZE, 60), (SIZE, SIZE))]
    want = JDetector(jfwd, NC, SIZE).detect_batch(frames)
    before = dict(launch_counts)
    det = Detector(None, NC, SIZE, device="cpu",
                   forward_fn=forward_for_eval(pmodel, NC, device="cpu"))
    got = det.detect_batch(frames)
    assert launch_counts == before
    for (gb, gs, gc), (wb, ws, wc), f in zip(got, want, frames):
        assert (gs >= 0.25).all()
        assert (gb[:, [0, 2]] <= f.shape[1]).all()
        _assert_same_dets((gb, gs, gc), (np.asarray(wb), np.asarray(ws),
                                         np.asarray(wc)))


def test_eval_entry_points_reject_bad_arguments(weights):
    """Detector needs exactly one of detect_fn and forward_fn, Evaluator one
    of forward_fn and step_fn; forward_for_eval refuses a class count other
    than the model's."""
    with pytest.raises(ValueError, match="exactly one"):
        Detector(None, NC, SIZE, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        Detector(lambda x: x, NC, SIZE, forward_fn=lambda x: x,
                 device="cpu")
    with pytest.raises(ValueError, match="forward_fn or step_fn"):
        TE.Evaluator(None, NC, device="cpu")
    with pytest.raises(ValueError, match="num_classes"):
        forward_for_eval(weights[2], NC + 1, device="cpu")
