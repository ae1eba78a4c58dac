"""Parity of the port's TTA ``Detector`` (views fused by WBF) and its
frontends with the JAX package on the CPU.

One set of weights (through ``from_jax_variables``) and the same frames go
through both ``Detector(tta=True)``. Both letterbox with the port's
``letterbox_np`` here (the reference's is patched to it), so the views see
the same pixels: the letterbox's own parity with cv2 (within one grey
level) is tested in tests/test_torch_port_serve.py, and one grey level
could move a candidate across the confidence threshold, which would test
the resize and not the TTA. The fused dets are compared as
tests/test_torch_port_serve.py compares the serve step's: the same det
multiset, every det within 0.1 px and 4e-3 of its partner, 95 % within
1e-2 px and 1e-5.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (imported before the JAX package, as its tests do)

cv2 = pytest.importorskip("cv2")

import heltondetection_tpu.engine.infer as j_infer
from heltondetection_tpu.engine.infer import Detector as JDetector
from heltondetection_tpu.utils.vis import draw_boxes as j_draw_boxes

from heltondetection_tpu_torch.data.letterbox import letterbox_np
from heltondetection_tpu_torch.data.readers import imread_rgb
from heltondetection_tpu_torch.engine.infer import Detector
from heltondetection_tpu_torch.kernels import launch_counts
from heltondetection_tpu_torch.ops.wbf import weighted_boxes_fusion
from heltondetection_tpu_torch.utils.vis import draw_boxes

from test_torch_port_model import jax_variables, port_model
from test_torch_port_serve import (NC, SIZE, _assert_same_dets, _noise,
                                   make_steps)

SCALES = (1.0, 0.75)          # 128 and 96: two input sizes for one step
MAX_DET = 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jmodel, variables = jax_variables(nc=NC, seed=3, head_scale=0.25)
    return jmodel, variables, port_model(variables, NC)


@pytest.fixture(scope="module")
def detectors(weights):
    """(JAX TTA detector, port TTA detector) over the packed serve steps."""
    jstep, pstep = make_steps(weights, max_det=MAX_DET, multi_label=False)
    kw = dict(tta=True, tta_scales=SCALES, wbf_iou=0.55, max_det=MAX_DET)
    return (JDetector(None, NC, SIZE, detect_fn=jstep, **kw),
            Detector(pstep, NC, SIZE, device="cpu", **kw))


FRAMES = [((96, SIZE, 3), 21), ((SIZE, 80, 3), 22), ((150, 200, 3), 23)]


def test_tta_detector_matches_jax(detectors, monkeypatch):
    """Three views per frame (identity, flip, the 96² letterbox), mixed
    sizes so each frame has its own remap factors: the fused dets match the
    JAX Detector's, in source coordinates, and no kernel launches on CPU
    tensors."""
    monkeypatch.setattr(j_infer, "letterbox_np", letterbox_np)
    jdet, pdet = detectors
    frames = [_noise(shape, seed) for shape, seed in FRAMES]
    # the reference in a thread: its XLA compiles leave the interpreter
    # lock to the port's views meanwhile
    with ThreadPoolExecutor(1) as pool:
        want = pool.submit(jdet.detect_batch, frames)
        before = dict(launch_counts)
        got = pdet.detect_batch(frames)
        assert launch_counts == before
        want = want.result()
    assert pdet.tta and pdet._n_views == 3
    for (gb, gs, gc), (wb, ws, wc), f in zip(got, want, frames):
        assert np.isfinite(gb).all() and (gs > 0).all()
        assert (gb >= 0).all() and (gb[:, [0, 2]] <= f.shape[1]).all()
        assert (gb[:, [1, 3]] <= f.shape[0]).all()
        _assert_same_dets((gb, gs, gc), (wb, ws, wc))


def test_tta_view_remap():
    """A step that finds the same relative box in whatever it is shown:
    the flip view's box is mirrored back, and the 96² view's box lands on
    the identity view's, for a square and a wide frame (its own pads)."""
    rel = torch.tensor([0.25, 0.25, 0.5, 0.75])

    def step(images):
        b, s = images.shape[0], images.shape[1]
        return ((rel * s).expand(b, 1, 4), torch.full((b, 1), 0.9),
                torch.zeros((b, 1), dtype=torch.int32),
                torch.ones((b, 1), dtype=torch.bool))

    det = Detector(step, NC, SIZE, tta=True, tta_scales=SCALES, device="cpu")
    frames = [_noise((200, 200, 3), 1), _noise((100, 200, 3), 2)]
    x, metas = det._letterbox(frames, SIZE)
    views = det._view_dets(frames, x, metas)
    assert [tuple(v[0].shape) for v in views] == [(2, 1, 4)] * 3
    want = torch.tensor([32.0, 32.0, 64.0, 96.0])
    assert torch.equal(views[0][0], want.expand(2, 1, 4))
    assert torch.equal(views[1][0],
                       torch.tensor([64.0, 32.0, 96.0, 96.0]).expand(2, 1, 4))
    # the wide frame's box is relative to its letterbox, pads included
    torch.testing.assert_close(views[2][0], want.expand(2, 1, 4), atol=1e-4,
                               rtol=0)
    (b, s, c), _ = det.detect_batch(frames)
    assert len(s) == 2 and c.tolist() == [0, 0]      # flip did not fuse
    np.testing.assert_allclose(sorted(s), [0.3, 0.6], atol=1e-6)


def test_tta_views_and_batching(detectors):
    """The fusion of a batch equals the fusion of each frame alone, and the
    step serves both input sizes; TTA differs from the single view."""
    _, pdet = detectors
    frames = [_noise(shape, seed) for shape, seed in FRAMES]
    x, metas = pdet._letterbox(frames, SIZE)
    with torch.inference_mode():
        views = pdet._view_dets(frames, x, metas)
    assert len(views) == 3
    for vb, vs, vc, vv in views:
        assert vb.shape == (3, MAX_DET, 4) and vv.dtype == torch.bool
        assert vv.any()
    fused = weighted_boxes_fusion(
        *(torch.cat([v[k] for v in views], 1) for k in range(4)),
        n_views=3, iou_thres=0.55, max_out=MAX_DET)
    batched = pdet.detect_batch(frames)
    for i, f in enumerate(frames):
        single = pdet.detect_batch([f])[0]
        for a, b in zip(single, batched[i]):
            np.testing.assert_allclose(a, b, atol=1e-4)
        assert len(batched[i][1]) == int(fused[3][i].sum())
    plain = Detector(pdet._detect, NC, SIZE, device="cpu").detect_batch(frames)
    assert all(len(p[1]) != len(t[1]) or not np.allclose(p[1], t[1])
               for p, t in zip(plain, batched))


def test_draw_boxes_and_image_file(detectors, tmp_path):
    """``draw_boxes`` is pixel-equal to the reference's; ``infer_image_file``
    reads, detects and writes the rendering."""
    _, pdet = detectors
    img = _noise((150, 200, 3), 31)
    boxes = np.array([[10.2, 20.7, 90.1, 120.5], [100, 5, 190, 60]],
                     np.float32)
    scores, classes = np.array([0.91, 0.333]), np.array([1, 7])
    for names in (None, ["a", "b", "c"]):
        np.testing.assert_array_equal(
            draw_boxes(img, boxes, scores, classes, names),
            j_draw_boxes(img, boxes, scores, classes, names))
    assert (draw_boxes(img, boxes, scores, classes) != img).any()
    src, out = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    cv2.imwrite(src, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    np.testing.assert_array_equal(imread_rgb(src), img)
    res = pdet.infer_image_file(src, out, class_names=["a", "b", "c", "d"])
    assert set(res) == {"boxes", "scores", "classes"}
    want = pdet.detect_image(img)
    np.testing.assert_array_equal(res["boxes"], want[0])
    assert imread_rgb(out).shape == img.shape
    with pytest.raises(FileNotFoundError):
        imread_rgb(str(tmp_path / "missing.png"))


def test_video_file(detectors, tmp_path):
    """``infer_video_file`` over a synthetic clip: every frame processed,
    the tail chunk padded, ``max_frames`` respected."""
    _, pdet = detectors
    vid, out = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 10, (128, 96))
    if not w.isOpened():
        pytest.skip("this OpenCV build cannot write mp4v")
    for k in range(5):
        w.write(_noise((96, 128, 3), 40 + k))
    w.release()
    det = Detector(pdet._detect, NC, SIZE, device="cpu")
    assert det.infer_video_file(vid, out, batch_frames=2) == 5
    assert det.infer_video_file(vid, out, batch_frames=4, max_frames=3) == 3
    with pytest.raises(FileNotFoundError):
        det.infer_video_file(str(tmp_path / "missing.mp4"), out)
