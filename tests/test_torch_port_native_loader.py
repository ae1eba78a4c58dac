"""The port's native loader (heltondetection_tpu_torch/native/loader_core.cpp,
data/native_loader.py, the ``sample_batch`` paths of data/loader.py) against
the JAX package's native loader on the CPU.

Both build the same loader core against the same system OpenCV and libjpeg,
and the port's pipelines draw from the same (seed, epoch, index) streams in
the same order, so every case here is bit equality with the reference's
native path on the same files and seeds: images, boxes, classes, masks and
``mosaic4``, with and without ``decode_in_pool``, per sample and pooled,
across thread counts, through both loaders. The file mirrors the
reference's tests/test_native_loader.py case by case, and skips where
either library cannot build (g++, or the OpenCV and libjpeg development
files, missing). Tiny images (75×101) keep it to seconds.
"""

import ctypes
import json

import numpy as np
import pytest
import torch

from heltondetection_tpu.data import loader as JLoad
from heltondetection_tpu.data import native_loader as JN
from heltondetection_tpu.data.readers import COCODataset as JCOCO
from heltondetection_tpu.native import get_loader_lib as j_loader_lib

from heltondetection_tpu_torch.data import loader as PLoad
from heltondetection_tpu_torch.data import native_loader as PN
from heltondetection_tpu_torch.data.readers import COCODataset as PCOCO
from heltondetection_tpu_torch.native import (get_loader_lib,
                                              loader_build_error)

from synth_data import build_coco_dataset

S = 96
TRAIN_KEYS = ("image", "gt_boxes", "gt_cls", "gt_mask")


@pytest.fixture(autouse=True, scope="module")
def _built():
    """Skip where either loader core cannot build; one torch thread."""
    if j_loader_lib() is None:
        pytest.skip("the reference's native loader core does not build here")
    if get_loader_lib() is None:
        pytest.skip(f"the port's native loader core does not build here: "
                    f"{loader_build_error()}")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """(the port's reader, the reference's) over 10 PNG files."""
    root = tmp_path_factory.mktemp("native_coco")
    ann, imgs = build_coco_dataset(str(root), n_images=10, hw=(75, 101))
    return PCOCO(ann, imgs), JCOCO(ann, imgs)


@pytest.fixture(scope="module")
def coco_jpg(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_coco_jpg")
    ann, imgs = build_coco_dataset(str(root), n_images=6, hw=(80, 105),
                                   ext="jpg")
    return PCOCO(ann, imgs), JCOCO(ann, imgs)


def _train_pair(pair, **kw):
    p_ds, j_ds = pair
    return (PN.NativeTrainPipeline(p_ds, S, **kw),
            JN.NativeTrainPipeline(j_ds, S, **kw))


def _assert_same(a, b, keys, where=""):
    for k in keys:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (where, k)


def test_primitives_equal_reference_library():
    """hd_letterbox, hd_hsv_jitter and hd_flip_h of the port's library give
    the reference library's bytes."""
    p, j = get_loader_lib(), j_loader_lib()
    src = np.random.default_rng(3).integers(0, 255, (67, 93, 3)) \
        .astype(np.uint8)
    outs = [np.empty((S, S, 3), np.uint8) for _ in range(2)]
    p.hd_letterbox(src, 67, 93, outs[0], S, 114)
    j.hd_letterbox(src, 67, 93, outs[1], S, 114)
    assert np.array_equal(*outs)
    r = np.random.default_rng(5).uniform(-1, 1, 3) * [0.015, 0.7, 0.4] + 1
    imgs = [src.copy(), src.copy()]
    p.hd_hsv_jitter(imgs[0], 67, 93, *map(float, r))
    j.hd_hsv_jitter(imgs[1], 67, 93, *map(float, r))
    assert np.array_equal(*imgs) and not np.array_equal(imgs[0], src)
    p.hd_flip_h(imgs[0], 67, 93)
    assert np.array_equal(imgs[0], imgs[1][:, ::-1])


def test_jpeg_decode_equals_cv2():
    import cv2
    lib = get_loader_lib()
    src = np.random.default_rng(0).integers(0, 255, (120, 77, 3)) \
        .astype(np.uint8)
    buf = np.frombuffer(cv2.imencode(
        ".jpg", cv2.cvtColor(src, cv2.COLOR_RGB2BGR))[1].tobytes(), np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    assert lib.hd_jpeg_dims(buf, buf.nbytes, ctypes.byref(h),
                            ctypes.byref(w)) == 0
    assert (h.value, w.value) == (120, 77)
    out = np.empty((120, 77, 3), np.uint8)
    assert lib.hd_decode_jpeg(buf, buf.nbytes, out, out.nbytes,
                              ctypes.byref(h), ctypes.byref(w)) == 0
    want = cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)
    assert np.array_equal(out, want)


@pytest.mark.parametrize("mosaic_p,affine", [(0.0, False), (1.0, False),
                                             (1.0, True), (0.5, True)])
def test_train_pipeline_equals_reference(coco, mosaic_p, affine):
    """Letterbox, mosaic-4 and the affine warp: every sample of two epochs
    bit-equal to the reference's native pipeline."""
    p, j = _train_pair(coco, mosaic_p=mosaic_p, affine=affine, seed=7)
    for epoch in (0, 1):
        for idx in range(len(p)):
            _assert_same(p.sample(idx, epoch), j.sample(idx, epoch),
                         TRAIN_KEYS, (epoch, idx))


def test_train_pipeline_with_mixup_equals_reference(coco):
    """Mixup (a second plan and the host blend) bit-equal, with mixups
    drawn."""
    p, j = _train_pair(coco, mosaic_p=0.5, affine=False, mixup_p=0.6,
                       seed=13)
    mixed = 0
    for epoch in (0, 1):
        for idx in range(len(p)):
            _assert_same(p.sample(idx, epoch), j.sample(idx, epoch),
                         TRAIN_KEYS, (epoch, idx))
            plans = p.plan(idx, epoch, np.empty((S, S, 3), np.uint8))[0]
            mixed += len(plans) == 2
    assert mixed > 0


def test_pool_batch_with_mixup_equals_reference_and_per_sample(coco):
    p, j = _train_pair(coco, mosaic_p=0.5, affine=False, mixup_p=0.7, seed=2)
    pp, jp = PN.NativePool(4), JN.NativePool(4)
    try:
        got = p.sample_batch(list(range(8)), 1, pp)
        _assert_same(got, j.sample_batch(list(range(8)), 1, jp), TRAIN_KEYS)
        for i in range(8):
            one = p.sample(i, 1)
            assert all(np.array_equal(got[k][i], one[k]) for k in TRAIN_KEYS)
    finally:
        pp.close()
        jp.close()


def test_pool_batch_equals_reference_and_per_sample(coco):
    p, j = _train_pair(coco, mosaic_p=0.7, seed=1)
    pp, jp = PN.NativePool(4), JN.NativePool(4)
    try:
        got = p.sample_batch(list(range(8)), 2, pp)
        _assert_same(got, j.sample_batch(list(range(8)), 2, jp), TRAIN_KEYS)
        for i in range(8):
            one = p.sample(i, 2)
            assert all(np.array_equal(got[k][i], one[k]) for k in TRAIN_KEYS)
    finally:
        pp.close()
        jp.close()


def test_train_loader_equals_reference_loader(coco):
    """``TrainLoader.epoch`` through ``sample_batch`` (the pinned upload
    path, on the CPU) gives the reference loader's batches."""
    p, j = _train_pair(coco, mosaic_p=0.5, seed=3, affine=False)
    with PLoad.TrainLoader(p, 4, seed=11, num_workers=2,
                           device="cpu") as pl, \
            JLoad.TrainLoader(j, 4, seed=11, num_workers=2) as jl:
        n = 0
        for a, b in zip(pl.epoch(0), jl.epoch(0)):
            assert set(a) == set(TRAIN_KEYS)
            _assert_same({k: v.numpy() for k, v in a.items()}, b, TRAIN_KEYS)
            n += 1
        assert n == pl.steps_per_epoch() == 2
        assert pl._pool is not None
    assert pl._pool is None


def test_eval_pipeline_and_loader_equal_reference(coco):
    """``NativeEvalPipeline`` per sample, and ``EvalLoader`` through
    ``sample_batch`` with its tail batch padded with ``img_id=None``."""
    p_ds, j_ds = coco
    p, j = PN.NativeEvalPipeline(p_ds, S), JN.NativeEvalPipeline(j_ds, S)
    keys = ("image", "img_id", "scale", "pad_x", "pad_y", "orig_hw")
    for idx in range(4):
        a, b = p.sample(idx), j.sample(idx)
        assert np.array_equal(a["image"], b["image"])
        assert [a[k] for k in keys[1:]] == [b[k] for k in keys[1:]]
    with PLoad.EvalLoader(p, 4, num_workers=2) as pl, \
            JLoad.EvalLoader(j, 4, num_workers=2) as jl:
        got, want = list(pl), list(jl)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert np.array_equal(a["image"], b["image"])
        assert [a[k] for k in keys[1:]] == [b[k] for k in keys[1:]]
    assert got[-1]["img_id"][2:] == [None, None]


def test_decode_in_pool_equals_host_decode_and_reference(coco_jpg):
    """libjpeg inside the pool (``load_encoded``: bytes and the annotation's
    size) gives the batches of the reader's own decode, and the
    reference's in-pool batches."""
    p_ds, j_ds = coco_jpg
    raw = p_ds.load_encoded(0)
    assert raw["jpeg"].dtype == np.uint8 and "image" not in raw
    assert (raw["height"], raw["width"]) == (80, 105)
    host = PN.NativeTrainPipeline(p_ds, S, mosaic_p=1.0, seed=5)
    pool, jpool = _train_pair(coco_jpg, mosaic_p=1.0, seed=5,
                              decode_in_pool=True)
    assert pool.decode_in_pool and not host.decode_in_pool
    for idx in range(len(p_ds)):
        a = pool.sample(idx, 0)
        _assert_same(a, host.sample(idx, 0), TRAIN_KEYS, idx)
        _assert_same(a, jpool.sample(idx, 0), TRAIN_KEYS, idx)


def test_pool_is_deterministic_across_thread_counts(coco):
    p, j = _train_pair(coco, mosaic_p=0.5, seed=9)
    p1, p8, jp = PN.NativePool(1), PN.NativePool(8), JN.NativePool(3)
    try:
        idxs = list(range(10))
        b1 = p.sample_batch(idxs, 0, p1)
        _assert_same(b1, p.sample_batch(idxs, 0, p8), TRAIN_KEYS)
        _assert_same(b1, j.sample_batch(idxs, 0, jp), TRAIN_KEYS)
    finally:
        for pool in (p1, p8, jp):
            pool.close()


def test_device_aug_pipeline_equals_reference(coco):
    """``NativeDeviceAugPipeline`` per sample over two epochs, and its pool
    batch, bit-equal to the reference's (``mosaic4`` included)."""
    p_ds, j_ds = coco
    kw = dict(max_boxes=8, seed=4, mosaic_p=0.5)
    p = PN.NativeDeviceAugPipeline(p_ds, S, **kw)
    j = JN.NativeDeviceAugPipeline(j_ds, S, **kw)
    keys = PLoad.TrainLoader.DEVICE_AUG_KEYS
    for epoch in (0, 1):
        for idx in range(len(p)):
            _assert_same(p.sample(idx, epoch), j.sample(idx, epoch), keys,
                         (epoch, idx))
    pp, jp = PN.NativePool(4), JN.NativePool(4)
    try:
        got = p.sample_batch(list(range(6)), 1, pp)
        _assert_same(got, j.sample_batch(list(range(6)), 1, jp), keys)
        for i in range(6):
            one = p.sample(i, 1)
            assert all(np.array_equal(got[k][i], one[k]) for k in keys)
    finally:
        pp.close()
        jp.close()


def test_half_pixel_rounding_equals_reference():
    """A (192, 33) source at S=96 lands w·scale exactly on .5: the core
    rounds half to even as Python's ``round`` does, so the tile and the box
    geometry agree (the reference's letterbox of the same source)."""
    from heltondetection_tpu.data.augment import letterbox_np
    src = np.random.default_rng(0).integers(0, 255, (192, 33, 3)) \
        .astype(np.uint8)
    out = np.empty((S, S, 3), np.uint8)
    get_loader_lib().hd_letterbox(src, 192, 33, out, S, 114)
    want, _, _ = letterbox_np(src, np.zeros((0, 4), np.float32), S)
    assert np.array_equal(out, want)


def test_decode_in_pool_rejects_wrong_metadata_dims(tmp_path):
    import cv2
    img = np.random.default_rng(1).integers(0, 255, (60, 80, 3)) \
        .astype(np.uint8)
    cv2.imwrite(str(tmp_path / "img.jpg"), img)
    ann = {"images": [{"id": 1, "file_name": "img.jpg",
                       "height": 80, "width": 60}],   # swapped on purpose
           "annotations": [], "categories": [{"id": 1, "name": "x"}]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    ds = PCOCO(str(tmp_path / "ann.json"), str(tmp_path))
    nat = PN.NativeTrainPipeline(ds, S, mosaic_p=0.0, decode_in_pool=True)
    with pytest.raises(RuntimeError, match="dims disagree"):
        nat.sample(0, 0)


def test_abandoned_epoch_then_new_epoch(coco):
    """An epoch abandoned after one batch stops and joins its producer
    before the next epoch drives the same pool."""
    p, _ = _train_pair(coco, mosaic_p=0.5, seed=2)
    with PLoad.TrainLoader(p, 4, seed=5, num_workers=2, prefetch=2,
                           device="cpu") as loader:
        it = loader.epoch(0)
        next(it)
        it.close()
        n = 0
        for batch in loader.epoch(1):
            assert batch["image"].shape[0] == 4
            n += 1
        assert n == loader.steps_per_epoch()
