"""Parity of the port's ``bbox_iou``/``clip_boxes`` and
``weighted_boxes_fusion`` with the JAX package on the CPU.

The same numpy-seeded inputs go through both. ``bbox_iou`` agrees to 1e-6
in every kind and format (float32 sums in another order, and two arctans).
WBF is a sequence of discrete choices (which cluster a candidate joins),
so classes and valid flags must be equal, and boxes and scores agree to
1e-4 px and 1e-6: the running score-weighted sums are accumulated in the
same order in float32 in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heltondetection_tpu.ops.boxes import bbox_iou as j_bbox_iou
from heltondetection_tpu.ops.boxes import clip_boxes as j_clip_boxes
from heltondetection_tpu.ops.wbf import weighted_boxes_fusion as j_wbf

from heltondetection_tpu_torch.ops.boxes import bbox_iou, clip_boxes
from heltondetection_tpu_torch.ops.wbf import weighted_boxes_fusion


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _xyxy(rng, n, size=200.0):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(2, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("fmt", ["xyxy", "cxcywh"])
@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_bbox_iou_matches_jax(kind, fmt):
    """Aligned and broadcast pairs, overlapping and disjoint, 1e-6."""
    rng = np.random.default_rng(7)
    a, b = _xyxy(rng, 64), _xyxy(rng, 64)
    b[:8] = a[:8]                                   # identical pairs
    if fmt == "cxcywh":
        def to_c(x):
            return np.concatenate([(x[:, :2] + x[:, 2:]) / 2,
                                   x[:, 2:] - x[:, :2]], -1)
        a, b = to_c(a), to_c(b)
    for x, y in ((a, b), (a[:, None, :], b[None, :8, :])):
        want = np.asarray(j_bbox_iou(jnp.asarray(x), jnp.asarray(y),
                                     fmt=fmt, kind=kind))
        got = bbox_iou(torch.from_numpy(x), torch.from_numpy(y), fmt=fmt,
                       kind=kind).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="unknown IoU kind"):
        bbox_iou(torch.from_numpy(a), torch.from_numpy(b), kind="siou")


def test_clip_boxes_matches_jax():
    b = np.random.default_rng(1).uniform(-50, 250, (3, 16, 4)).astype(
        np.float32)
    want = np.asarray(j_clip_boxes(jnp.asarray(b), 100.0, 180.0))
    np.testing.assert_array_equal(
        clip_boxes(torch.from_numpy(b), 100.0, 180.0).numpy(), want)


def _views(rng, n_obj, n_views, n_pad, jitter=3.0, nc=3):
    """``n_views`` jittered copies of ``n_obj`` objects, one dropped per
    view, plus ``n_pad`` invalid rows with junk boxes and high scores."""
    base = _xyxy(rng, n_obj)
    cls = rng.integers(0, nc, n_obj)
    boxes, scores, classes, valid = [], [], [], []
    for v in range(n_views):
        seen = np.ones(n_obj, bool)
        seen[rng.integers(0, n_obj)] = False
        boxes.append(base[seen] + rng.normal(0, jitter, (seen.sum(), 4)))
        scores.append(rng.uniform(0.05, 0.95, seen.sum()))
        classes.append(cls[seen])
        valid.append(np.ones(seen.sum(), bool))
    boxes.append(_xyxy(rng, n_pad))
    scores.append(rng.uniform(0.9, 1.0, n_pad))
    classes.append(rng.integers(0, nc, n_pad))
    valid.append(np.zeros(n_pad, bool))
    order = rng.permutation(sum(len(s) for s in scores))
    return (np.concatenate(boxes).astype(np.float32)[order],
            np.concatenate(scores).astype(np.float32)[order],
            np.concatenate(classes).astype(np.int32)[order],
            np.concatenate(valid)[order])


def _both(b, s, c, v, **kw):
    want = [np.asarray(t) for t in j_wbf(
        jnp.asarray(b), jnp.asarray(s), jnp.asarray(c), jnp.asarray(v), **kw)]
    got = [t.numpy() for t in weighted_boxes_fusion(
        torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(c),
        torch.from_numpy(v), **kw)]
    return got, want


def _assert_fused_equal(got, want):
    gb, gs, gc, gv = got
    wb, ws, wc, wv = want
    assert gb.shape == wb.shape and gv.dtype == bool
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gs, ws, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gb, wb, atol=1e-4, rtol=0)


CASES = {
    "three-view clusters": dict(n_obj=12, n_views=3, n_pad=0),
    "invalid rows": dict(n_obj=10, n_views=3, n_pad=9),
    "two views, tight jitter": dict(n_obj=20, n_views=2, n_pad=4, jitter=1.0),
    "one class, loose jitter": dict(n_obj=15, n_views=3, n_pad=0, jitter=8.0,
                                    nc=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_wbf_matches_jax(case):
    kw = CASES[case]
    b, s, c, v = _views(np.random.default_rng(len(case)), **kw)
    got, want = _both(b, s, c, v, n_views=kw["n_views"], iou_thres=0.55,
                      max_out=16)
    _assert_fused_equal(got, want)
    n_valid_in = int(v.sum())
    assert 0 < got[3].sum() < n_valid_in            # fusion merged some
    assert (np.diff(got[1][got[3]]) <= 0).all()     # score order


def test_wbf_all_invalid_and_class_mismatch_and_padding():
    """All rows invalid → nothing valid; the same box in two classes is not
    fused; N < max_out pads with zero boxes, score 0 and class −1."""
    rng = np.random.default_rng(3)
    b, s, c, v = _views(rng, n_obj=6, n_views=2, n_pad=2)
    got, want = _both(b, s, c, np.zeros_like(v), n_views=2, max_out=8)
    _assert_fused_equal(got, want)
    assert not got[3].any() and (got[2] == -1).all() and (got[0] == 0).all()

    two = np.array([[10, 10, 50, 50], [12, 12, 52, 52]], np.float32)
    got, want = _both(two, np.array([0.8, 0.7], np.float32),
                      np.array([0, 1], np.int32), np.ones(2, bool),
                      n_views=2, max_out=8)
    _assert_fused_equal(got, want)
    assert got[3].sum() == 2 and got[0].shape == (8, 4)
    assert (got[2][2:] == -1).all() and (got[1][2:] == 0).all()

    got, want = _both(two, np.array([0.8, 0.4], np.float32),
                      np.zeros(2, np.int32), np.ones(2, bool), n_views=2,
                      max_out=8)
    _assert_fused_equal(got, want)
    assert got[3].sum() == 1 and abs(got[1][0] - 0.6) < 1e-6
    np.testing.assert_allclose(
        got[0][0], (0.8 * two[0] + 0.4 * two[1]) / 1.2, atol=1e-4)


def test_wbf_batched_equals_per_image():
    """The batched form (state (B, N, …), one loop for the batch) gives each
    image what a call on that image alone gives, exactly, and what the
    JAX function under vmap gives; images with fewer valid rows than the
    batch's longest are not disturbed by the extra steps, which meet their
    invalid rows (NaN boxes in the first image)."""
    rng = np.random.default_rng(11)
    imgs = [_views(rng, n_obj=n, n_views=3, n_pad=40 - 3 * (n - 1))
            for n in (4, 9, 13)]
    b, s, c, v = (np.stack([im[k] for im in imgs]) for k in range(4))
    assert b.shape == (3, 40, 4)
    b[0][~v[0]] = np.nan           # junk in invalid rows must stay inert
    kw = dict(n_views=3, iou_thres=0.55, max_out=12)
    batched = weighted_boxes_fusion(*(torch.from_numpy(t)
                                      for t in (b, s, c, v)), **kw)
    for i in range(3):
        single = weighted_boxes_fusion(*(torch.from_numpy(t[i])
                                         for t in (b, s, c, v)), **kw)
        for x, y in zip(batched, single):
            assert torch.equal(x[i], y)
    want = [np.asarray(t) for t in jax.vmap(
        lambda *a: j_wbf(*a, **kw))(*(jnp.asarray(t) for t in (b, s, c, v)))]
    _assert_fused_equal([t.numpy() for t in batched], want)
    assert batched[2].dtype == torch.int32
    empty = weighted_boxes_fusion(
        torch.zeros((0, 5, 4)), torch.zeros((0, 5)),
        torch.zeros((0, 5), dtype=torch.int32),
        torch.zeros((0, 5), dtype=torch.bool), n_views=2, max_out=3)
    assert empty[0].shape == (0, 3, 4)
