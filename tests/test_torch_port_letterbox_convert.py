"""The port's device letterbox (ops/letterbox.py) and Ultralytics loader
(utils/torch_convert.py) against the JAX package's on the CPU, on seeded
numpy inputs.

Tolerances, each with its reason:

* ``letterbox_params``: exact, over a sweep of source sizes (the same
  float32 division, product and rounding).
* ``apply_to_boxes`` / ``invert_boxes``: 1e-4 px against the reference on
  tests/test_letterbox.py's cases, and their round trip to 1e-3 px, that
  file's bound.
* ``letterbox_image``: pads exact; the resized pixels within 1e-3 grey
  levels of ``jax.image.resize`` (both antialias a downscale with the
  same triangle filter; they sum its taps in another order).
* The state-dict maps: bit for bit (they move tensors, never compute).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heltondetection_tpu.ops import letterbox as JL
from heltondetection_tpu.utils import torch_convert as JT

from heltondetection_tpu_torch.ops import letterbox as PL
from heltondetection_tpu_torch.utils import torch_convert as PT
from heltondetection_tpu_torch.utils.convert import from_jax_variables

from test_torch_convert import _make_ultralytics_sd
from torch_refs import TorchYOLOv5, load_ultralytics_state_dict, \
    make_resnet_sd


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- letterbox -----------------------------------------------------------------

def test_letterbox_params_equal_reference():
    """Scale, pads and resized size equal the reference's for every
    source size of a sweep, centred and not."""
    for h in range(1, 2000, 37):
        for w in (77, 333, 500, 640, 1080, 1920):
            for center in (True, False):
                want = JL.letterbox_params(h, w, 640, 512, center=center)
                got = PL.letterbox_params(h, w, 640, 512, center=center)
                assert [float(g) for g in got] == \
                    [float(x) for x in want], (h, w, center)


@pytest.mark.parametrize("hw", [(480, 640), (1080, 1920), (333, 500)])
def test_letterbox_boxes_equal_reference(hw):
    """tests/test_letterbox.py's box round trip: forward and inverse equal
    the reference's, the round trip returns the boxes, and the forward
    boxes lie on the canvas."""
    h, w = hw
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, [w * 0.7, h * 0.7], (16, 2))
    boxes = np.concatenate(
        [xy, xy + rng.uniform(1, [w * 0.3, h * 0.3], (16, 2))], 1
    ).astype(np.float32)
    jp, pp = JL.letterbox_params(h, w, 640, 640), \
        PL.letterbox_params(h, w, 640, 640)
    want_f = np.asarray(JL.apply_to_boxes(jnp.asarray(boxes), jp))
    fwd = PL.apply_to_boxes(torch.from_numpy(boxes), pp)
    np.testing.assert_allclose(fwd.numpy(), want_f, rtol=0, atol=1e-4)
    want_b = np.asarray(JL.invert_boxes(jnp.asarray(want_f), jp, src_h=h,
                                        src_w=w))
    back = PL.invert_boxes(fwd, pp, src_h=h, src_w=w)
    np.testing.assert_allclose(back.numpy(), want_b, rtol=0, atol=1e-4)
    np.testing.assert_allclose(back.numpy(), boxes, atol=1e-3)
    f = fwd.numpy()
    assert (f >= -1e-3).all() and (f <= 640 + 1e-3).all()


@pytest.mark.parametrize("hw", [(480, 640), (1080, 1920), (333, 500),
                                (100, 60)])
def test_letterbox_image_equals_reference(hw):
    """The 1:1 case (tests/test_letterbox.py's), a downscale, an upscale
    and a tall image: the same canvas, pad bands of 114 exactly, resized
    pixels within 1e-3 of ``letterbox_image_jax``'s."""
    h, w = hw
    img = np.random.default_rng(1).uniform(0, 255, (h, w, 3)) \
        .astype(np.float32)
    want, jp = JL.letterbox_image_jax(jnp.asarray(img), 640, 640)
    got, pp = PL.letterbox_image(torch.from_numpy(img), 640, 640)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert [float(x) for x in pp] == [float(x) for x in jp]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    top, left = int(pp.pad_y), int(pp.pad_x)
    assert (got[:top] == 114.0).all() and (got[:, :left] == 114.0).all()


# -- the Ultralytics loader -----------------------------------------------------

def test_convert_yolov5_equals_reference_bridge():
    """An Ultralytics yolov5s state dict maps straight onto the port's
    YOLOv5: the same tensors, bit for bit, as the reference's
    ``convert_yolov5`` carried over by ``from_jax_variables``, and a
    strict load."""
    sd = _make_ultralytics_sd("s", nc=80, seed=2)
    P, S = JT.convert_yolov5(sd, depth_multiple=0.33)
    want = from_jax_variables({"params": P, "batch_stats": S})
    got = PT.convert_yolov5(sd, depth_multiple=0.33)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    from heltondetection_tpu_torch.models.yolov5 import YOLOv5
    with torch.device("meta"):
        model = YOLOv5(80, 0.33, 0.50)
    model.load_state_dict(got, strict=True, assign=True)


def test_export_state_dicts_round_trip_bit_exact():
    """``export_yolov5_state_dict`` and ``export_resnet_state_dict`` invert
    the port's converters exactly; the only keys they add are torch's
    ``num_batches_tracked``."""
    sd = _make_ultralytics_sd("s", nc=80, seed=11)
    out = PT.export_yolov5_state_dict(PT.convert_yolov5(sd))
    for k, v in sd.items():
        assert torch.equal(out[k], v), k
    assert all(k.endswith("num_batches_tracked") for k in set(out) - set(sd))
    rsd = make_resnet_sd((2, 2, 2, 2), "basic", seed=3)
    back = PT.export_resnet_state_dict(PT.convert_resnet(rsd))
    for k, v in rsd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    assert all(k.endswith("num_batches_tracked")
               for k in set(back) - set(rsd))


def test_load_ultralytics_checkpoint(tmp_path):
    """A yolov5n checkpoint: as a plain state dict (the safe loader) it
    loads into the port's YOLOv5, whose raw maps equal the independent
    torch oracle's on the same file within 1e-4; the port's model
    exported and saved with ``save_torch_state_dict`` reloads
    ``weights_only`` and bit-exactly; a full-model pickle is refused
    with ``allow_pickle=False`` and loads with it."""
    nc = 7
    sd = _make_ultralytics_sd("n", nc=nc, seed=5)
    path = str(tmp_path / "plain.pt")
    torch.save(sd, path)
    model, got_sd = PT.load_ultralytics_checkpoint(path, num_classes=nc,
                                                   variant="n",
                                                   allow_pickle=False,
                                                   device="cpu")
    net = TorchYOLOv5(nc=nc, depth_multiple=0.33, width_multiple=0.25)
    load_ultralytics_state_dict(net, sd)
    x = np.random.default_rng(6).uniform(0, 1, (1, 64, 64, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        want = net.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy().transpose(0, 2, 3, 1),
                                   atol=1e-4, rtol=1e-4)
    out = str(tmp_path / "export.pth")
    PT.save_torch_state_dict(out, PT.export_yolov5_state_dict(got_sd))
    again = torch.load(out, weights_only=True)
    for k, v in sd.items():
        assert torch.equal(again[k], v), k
    full = str(tmp_path / "full.pt")
    torch.save({"model": net}, full)
    with pytest.raises(ValueError, match="allow_pickle"):
        PT.load_ultralytics_checkpoint(full, num_classes=nc, variant="n",
                                       allow_pickle=False, device="cpu")
    loaded, _ = PT.load_ultralytics_checkpoint(full, num_classes=nc,
                                               variant="n", device="cpu")
    for a, b in zip(loaded.state_dict().values(),
                    model.state_dict().values()):
        assert torch.equal(a, b)
