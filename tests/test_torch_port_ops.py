"""Parity of the port's ops (heltondetection_tpu_torch/ops) with the JAX
package on the CPU: NMS keep masks, box geometry and anchors, and the fused
packed postprocess. Inputs come from numpy seeds and go to both packages.

Tolerances: NMS masks and class ids are exact; the random boxes carry no
IoU sitting exactly on the threshold, so the two predicates in use
(``inter > thr·union`` here and in the Pallas kernels, ``inter/union > thr``
in the reference's XLA paths) agree. Geometry matches at 1e-6; decoded
boxes at 2e-3 px, since XLA's and PyTorch's sigmoid differ in the last bits
and the decode scales by up to the stride.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from heltondetection_tpu.models.yolov5 import packed_cls_width
from heltondetection_tpu.ops import anchors as JA
from heltondetection_tpu.ops import boxes as JB
from heltondetection_tpu.ops import nms as JN
from heltondetection_tpu.ops import postprocess as JP

from heltondetection_tpu_torch.kernels import launch_counts
from heltondetection_tpu_torch.kernels import nms as nms_kernel
from heltondetection_tpu_torch.ops import anchors as TA
from heltondetection_tpu_torch.ops import boxes as TB
from heltondetection_tpu_torch.ops import nms as TN
from heltondetection_tpu_torch.ops import postprocess as TP


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sorted_boxes(n, seed, size=250):
    """Score-sorted random xyxy boxes (n, 4) f32, dense enough to overlap."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(4, size * 0.3, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    order = np.argsort(-rng.uniform(0.01, 1.0, n), kind="stable")
    return boxes[order]


def _chain(n):
    """Alternating suppression chain, n deep: box i overlaps only its
    neighbours, iou(i, i+1) = 8/12 > 0.65 (tests/test_nms.py)."""
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        boxes[i] = [i * 2.0, 0.0, i * 2.0 + 10.0, 10.0]
    return boxes


def _padded_class_offset(n, seed, n_pad):
    """Class-offset boxes with zeroed padding rows at the end, as
    nms_sorted_candidates hands them to the kernel."""
    rng = np.random.default_rng(seed)
    boxes = _sorted_boxes(n, seed, size=120)
    cls = rng.integers(0, 3, n).astype(np.float32)
    boxes = boxes + cls[:, None] * 8192.0
    boxes[n - n_pad:] = 0.0
    return boxes


def _port_masks(boxes, thr):
    t = torch.from_numpy(boxes)
    return (TN.nms_mask_seq(t, thr).numpy(),
            TN.nms_mask_fixpoint(t, thr).numpy(),
            TN.nms_mask_fixpoint_batched(t[None], thr)[0].numpy())


@pytest.mark.parametrize("case", ["random", "chain", "padding"])
def test_nms_masks_match_jax(case):
    """(a) every plain keep mask of the port equals nms_mask_jnp,
    nms_mask_fixpoint and the Pallas fixpoint kernel in interpret mode."""
    if case == "random":
        batch, thr = np.stack([_sorted_boxes(128, s) for s in range(3)]), 0.5
    elif case == "chain":
        batch, thr = _chain(256)[None], 0.65      # 256 > any iteration cap
    else:
        batch = np.stack([_padded_class_offset(128, s, 40) for s in range(2)])
        thr = 0.5
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(JN.nms_mask_fixpoint_pallas(jnp.asarray(batch),
                                                        thr))
    seq = jax.jit(lambda b: JN.nms_mask_jnp(b, None, thr))
    fixpoint = jax.jit(lambda b: JN.nms_mask_fixpoint(b, None, thr))
    for i, boxes in enumerate(batch):
        want = np.asarray(seq(jnp.asarray(boxes)))
        fix = np.asarray(fixpoint(jnp.asarray(boxes)))
        np.testing.assert_array_equal(fix, want)
        np.testing.assert_array_equal(pallas[i], want)
        for got in _port_masks(boxes, thr):
            np.testing.assert_array_equal(got, want)
    if case == "chain":
        assert want.sum() == 128                  # alternating keep pattern


def test_nms_batched_cpu_is_plain_and_launches_nothing():
    batch = torch.from_numpy(np.stack([_sorted_boxes(96, s) for s in (4, 5)]))
    before = dict(launch_counts)
    got = TN.nms_mask_fixpoint_batched(batch, 0.5)
    assert got.dtype == torch.bool and got.shape == (2, 96)
    torch.testing.assert_close(got, TN.nms_mask_fixpoint(batch, 0.5))
    assert launch_counts == before


@pytest.mark.parametrize("bad", ["cpu", "float64", "shape"])
def test_nms_kernel_wrapper_rejects_what_it_cannot_run(bad):
    """The CUDA wrapper takes only contiguous f32 (B, N, 4) CUDA tensors and
    raises on anything else, before building or launching."""
    boxes = torch.zeros((1, 64, 4))
    if bad == "float64":
        boxes = boxes.double()
    elif bad == "shape":
        boxes = boxes[0]
    before = dict(launch_counts)
    with pytest.raises(ValueError):
        nms_kernel.nms_fixpoint(boxes, 0.5)
    assert launch_counts == before


def test_box_geometry_matches_jax():
    """(b) box_iou_matrix, box_area and the converters at atol 1e-6."""
    rng = np.random.default_rng(0)
    a = _sorted_boxes(37, 1)
    b = _sorted_boxes(53, 2)
    np.testing.assert_allclose(
        TB.box_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(JB.box_iou_matrix(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6)
    x = rng.uniform(-5, 50, (3, 11, 4)).astype(np.float32)
    for name in ("box_area", "cxcywh_to_xyxy", "xyxy_to_cxcywh",
                 "xywh_to_xyxy", "xyxy_to_xywh"):
        np.testing.assert_allclose(
            getattr(TB, name)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(JB, name)(jnp.asarray(x))), atol=1e-6,
            err_msg=name)
    assert TB.EPS == JB.EPS


def test_anchors_match_jax():
    """(b) anchor constants, normalize_anchors and yolo_grid."""
    assert TA.YOLOV5_ANCHORS == JA.YOLOV5_ANCHORS
    assert TA.YOLOV5_STRIDES == JA.YOLOV5_STRIDES
    custom = [np.array([[1, 2], [3, 4.5]]), [[5, 6], [7, 8]]]
    assert TA.normalize_anchors(custom) == JA.normalize_anchors(custom)
    np.testing.assert_allclose(TA.yolo_grid(5, 7).numpy(),
                               np.asarray(JA.yolo_grid(5, 7)), atol=1e-6)
    with pytest.raises(ValueError):
        TA.normalize_anchors([[[1, 2]], [[1, 2], [3, 4]]])


@pytest.mark.parametrize("order", ["yxa", "ayx"])
def test_decode_tables_match_jax(order):
    for t, j in zip(TP._flat_decode_tables((96, 64), order=order),
                    JP._flat_decode_tables((96, 64), order=order)):
        np.testing.assert_array_equal(t, j)


def test_topk_orders_ties_like_lax():
    """Equal values come out lower index first, as lax.top_k orders them."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 5, (4, 300)).astype(np.float32)
    tv, ti = TP._topk(torch.from_numpy(x), 100)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 100)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_per_candidate_classes_bf16_ties_match_jax():
    rng = np.random.default_rng(4)
    x = rng.integers(-3, 3, (2, 50, 9)).astype(np.float32)  # many ties
    tv, ti = TP._per_candidate_classes(
        torch.from_numpy(x).to(torch.bfloat16), 4)
    jv, ji = JP._per_candidate_classes(jnp.asarray(x, jnp.bfloat16), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv, np.float32))


def _packed_synthetic(seed, b=2, nc=7, sizes=(8, 4, 2)):
    """Random packed head outputs (numpy): per level (pobj f32, [pcand_a f32
    holding bf16-exact values], (h, w)), pad lanes at −20."""
    rng = np.random.default_rng(seed)
    cp = packed_cls_width(nc)
    packed = []
    for s in sizes:
        po = rng.normal(-2, 2, (b, 3 * s * s)).astype(np.float32)
        pcs = []
        for _a in range(3):
            pc = np.full((b, s * s, cp), -20.0, np.float32)
            pc[..., :nc + 5] = rng.normal(-1, 2, (b, s * s, nc + 5))
            pcs.append(np.asarray(jnp.asarray(pc, jnp.bfloat16), np.float32))
        packed.append((po, pcs, (s, s)))
    return packed


def _to_jax(packed):
    return [(jnp.asarray(po), [jnp.asarray(pc, jnp.bfloat16) for pc in pcs],
             hw) for po, pcs, hw in packed]


def _to_torch(packed):
    return [(torch.from_numpy(po),
             [torch.from_numpy(pc).to(torch.bfloat16) for pc in pcs], hw)
            for po, pcs, hw in packed]


CUSTOM_ANCHORS = (((8.0, 9.0), (20.0, 14.0), (12.0, 30.0)),
                  ((40.0, 35.0), (30.0, 70.0), (75.0, 50.0)),
                  ((90.0, 120.0), (160.0, 110.0), (220.0, 260.0)))


@pytest.mark.parametrize("topk,max_cls,anchors", [
    (64, 4, None), (512, 4, None), (256, 1, CUSTOM_ANCHORS)])
def test_fused_select_decode_packed_matches_jax(topk, max_cls, anchors):
    """(e) on identical packed inputs: the same candidates in the same order
    (classes exact, scores to float rounding) and boxes at atol 2e-3.
    topk 64 truncates stage 1 (252 anchors); 512 pads the output; the last
    case keeps one class per box and decodes with other anchors."""
    nc = 7
    packed = _packed_synthetic(5, nc=nc)
    kw = dict(topk=topk, conf_thres=0.01, max_cls_per_box=max_cls)
    if anchors is not None:
        kw["anchors"] = anchors
    jpacked = _to_jax(packed)
    jb, js, jc = (np.asarray(t) for t in jax.jit(
        lambda: JP.fused_select_decode_packed(jpacked, nc, **kw))())
    tb, ts, tc = (t.numpy() for t in TP.fused_select_decode_packed(
        _to_torch(packed), nc, **kw))
    assert tb.shape == (2, topk, 4) and tc.dtype == np.int32
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ts, js, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tb, jb, atol=2e-3)
    assert (tc[ts > 0] >= 0).all() and (tc[ts == 0] == -1).all()


@pytest.mark.parametrize("max_det", [None, 32, 200])
def test_nms_sorted_candidates_matches_jax(max_det):
    """(e) class-aware NMS over sorted candidates: the same dets, with the
    port's CPU path (plain fixpoint) against the reference's XLA path."""
    rng = np.random.default_rng(6)
    b, k = 3, 128
    boxes = rng.uniform(0, 64, (b, k, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(4, 24, (b, k, 2))
    scores = np.sort(rng.uniform(0.01, 1, (b, k)).astype(np.float32),
                     axis=1)[:, ::-1].copy()
    scores[:, -20:] = 0.0                          # sub-threshold padding
    classes = rng.integers(0, 3, (b, k)).astype(np.int32)
    classes[:, -20:] = -1
    want = jax.jit(lambda *a: JP.nms_sorted_candidates(
        *a, iou_thres=0.5, max_det=max_det, use_pallas=False))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes))
    got = TP.nms_sorted_candidates(torch.from_numpy(boxes),
                                   torch.from_numpy(scores),
                                   torch.from_numpy(classes), iou_thres=0.5,
                                   max_det=max_det)
    rows = k if max_det is None else max_det
    for g, w in zip(got, want):
        assert g.shape[:2] == (b, rows)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
