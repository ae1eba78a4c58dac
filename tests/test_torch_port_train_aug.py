"""Parity of the port's train-time regularizers and on-device augmentation
with the JAX package's on the CPU (heltondetection_tpu_torch/models/
dropblock.py, models/common.py ``checkpointed``, data/device_aug.py,
data/augment.py ``DeviceAugPipeline``).

The random draws are the reference's own: ``drop_block`` takes the
uniforms behind the reference's ``jax.random.bernoulli`` and the device
augmentation takes the crop offsets, flips, colour gains and mixup coins
and ratios of the reference's ``jax.random.split`` chain. Tolerances:

- ``drop_block``: the same dropped blocks exactly, values within 1e-6
  (relative and absolute): one float32 division;
- ``rgb_jitter``, ``device_mosaic`` and ``device_augment_batch``: pixels
  within 1e-5 (float32 on [0, 1]; ``cos`` and ``sin`` may differ by an
  ulp), boxes within 1e-4 px, classes and masks exactly;
- remat: the same loss, gradients, BatchNorm running statistics and
  ``num_batches_tracked`` as the plain step, exactly (the same operations
  in the same order on one thread);
- ``DeviceAugPipeline``: the same mosaic coins, tiles, boxes (1e-4 px),
  classes and masks; pixels within 1 grey level (torch's bilinear resize
  against cv2's fixed point, as in the train data tests);
- the samplers by statistics: each mean within 5 standard errors, and
  DropBlock's dropped share within 0.05 of ``drop_prob`` (its seed rate
  is set for that share, which overlapping blocks lower a little).
"""

import copy
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heltondetection_tpu.data import augment as JA
from heltondetection_tpu.data import device_aug as JD
from heltondetection_tpu.data import readers as JR
from heltondetection_tpu.models import dropblock as JDB

from heltondetection_tpu_torch.data import augment as PA
from heltondetection_tpu_torch.data import device_aug as PD
from heltondetection_tpu_torch.data import readers as PR
from heltondetection_tpu_torch.data.loader import TrainLoader
from heltondetection_tpu_torch.models.common import BatchNorm2d, init_weights
from heltondetection_tpu_torch.models.dropblock import (DropBlock, draw_shape,
                                                        drop_block,
                                                        reseed_dropblock)
from heltondetection_tpu_torch.models.yolov5 import YOLOv5
from heltondetection_tpu_torch.train.schedule import make_optimizer
from heltondetection_tpu_torch.train.trainer import (create_train_state,
                                                     make_train_step)
from heltondetection_tpu_torch.train.yolo_loss import YoloLossConfig

from synth_data import build_coco_dataset


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape, p, bs", [
    ((2, 20, 20, 8), 0.5, 7), ((1, 40, 24, 4), 0.2, 7),
    ((2, 5, 9, 3), 0.5, 7), ((2, 16, 16, 4), 0.3, 4)])
def test_drop_block_matches_reference(shape, p, bs):
    """The reference's blocks on its own draws (block size clipped to the
    map where it is larger, and an even one)."""
    rng = jax.random.PRNGKey(sum(shape))
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(JDB.drop_block(jnp.asarray(x), rng, p, bs))
    u = jax.random.uniform(rng, draw_shape(_nchw(x), bs))
    got = drop_block(_nchw(x), _nchw(u), p, bs).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (want == 0).any() and (want != 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="draws"):
        drop_block(_nchw(x), _nchw(u)[:, :, 1:], p, bs)


def test_dropblock_module_draws():
    """Training mode only; each call a fresh draw; the same seed the same
    draws; the dropped share near ``drop_prob``; the dtype kept."""
    m = DropBlock(0.3, 7)
    x = torch.ones(4, 16, 80, 80)
    assert m.eval()(x) is x
    m.train()
    reseed_dropblock(m, 5, 2)
    a, b = m(x), m(x)
    assert not torch.equal(a, b)
    reseed_dropblock(m, 5, 2)
    assert torch.equal(m(x), a)
    reseed_dropblock(m, 5, 3)
    assert not torch.equal(m(x), a)
    # 64 (image, channel) maps of 6400 cells: a mean of 409600 block cells
    dropped = float((a == 0).float().mean())
    assert abs(dropped - 0.3) < 0.05, dropped
    assert m(x.to(torch.bfloat16)).dtype == torch.bfloat16


def _model(remat, dropblock_p=0.5):
    m = YOLOv5(3, 0.33, 0.125, packed_train=True, dropblock_p=dropblock_p,
               remat=remat)
    init_weights(m, torch.Generator().manual_seed(0))
    return m.to(memory_format=torch.channels_last)


def test_remat_step_equals_plain_step():
    """Two train steps with the backbone checkpointed equal the plain ones,
    DropBlock on: the loss, every gradient, the running statistics and
    ``num_batches_tracked`` (the rerun in the backward pass holds them),
    and the state dict's names."""
    g = np.random.default_rng(1)
    batch = {"image": torch.from_numpy(g.uniform(0, 1, (2, 64, 64, 3))
                                       .astype(np.float32)),
             "gt_boxes": torch.from_numpy(g.uniform(16, 40, (2, 4, 4))
                                          .astype(np.float32)),
             "gt_cls": torch.from_numpy(g.integers(0, 3, (2, 4))),
             "gt_mask": torch.ones(2, 4, dtype=torch.bool)}
    cfg = YoloLossConfig(num_classes=3, img_size=64)
    runs = []
    for remat in (False, True):
        m = _model(remat)
        st = create_train_state(m, make_optimizer(m, 1e-3, total_steps=4,
                                                  warmup_steps=1))
        step = make_train_step(cfg, seed=9)
        mets = [step(st, batch)[1] for _ in range(2)]
        runs.append((m, mets))
    (m0, a), (m1, b) = runs
    assert m0.backbone.remat is False and m1.backbone.remat is True
    for x, y in zip(a, b):
        assert {k: float(v) for k, v in x.items()} == \
            {k: float(v) for k, v in y.items()}
    for (n0, p0), (n1, p1) in zip(m0.named_parameters(),
                                  m1.named_parameters()):
        assert n0 == n1 and torch.equal(p0.grad, p1.grad), n0
    s0, s1 = m0.state_dict(), m1.state_dict()
    assert list(s0) == list(s1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    bn = m1.backbone.stem.bn
    assert isinstance(bn, BatchNorm2d) and int(bn.num_batches_tracked) == 2
    assert not bn.hold_stats


def _ref_draws(rng, b, s, flip_p, mixup_p, h_gain=0.015, s_gain=0.7,
               v_gain=0.4):
    """The draws the reference's ``device_augment_batch`` makes from
    ``rng``, by its own ``jax.random.split`` chain."""
    oy, ox, flip, hsv = [], [], [], []
    for r in jax.random.split(rng, b):
        k_oy, k_ox, k_flip, k_hsv = jax.random.split(r, 4)
        oy.append(int(jax.random.randint(k_oy, (), 0, s + 1)))
        ox.append(int(jax.random.randint(k_ox, (), 0, s + 1)))
        flip.append(bool(jax.random.uniform(k_flip) < flip_p))
        kh, ks, kv = jax.random.split(k_hsv, 3)
        v = 1.0 + jax.random.uniform(kv, (), minval=-v_gain, maxval=v_gain)
        sat = 1.0 + jax.random.uniform(ks, (), minval=-s_gain,
                                       maxval=s_gain)
        h = jax.random.uniform(kh, (), minval=-h_gain,
                               maxval=h_gain) * jnp.pi * 2
        hsv.append(np.asarray([h, sat, v], np.float32))
    draws = PD.AugDraws(torch.tensor(oy), torch.tensor(ox),
                        torch.tensor(flip), torch.from_numpy(np.stack(hsv)))
    if mixup_p > 0:
        k_coin, k_r = jax.random.split(jax.random.fold_in(rng, 0x6D78))
        draws.mix = torch.from_numpy(np.array(
            jax.random.uniform(k_coin, (b,)) < mixup_p))
        draws.mix_r = torch.from_numpy(np.array(
            jax.random.beta(k_r, 32.0, 32.0, (b,))))
    return draws


def _tiles(b, s=32, m=6, seed=0):
    g = np.random.default_rng(seed)
    images4 = g.integers(0, 256, (b, 4, s, s, 3)).astype(np.uint8)
    xy = g.uniform(-4, s - 6, (b, 4, m, 2))
    wh = g.uniform(1, 20, (b, 4, m, 2))
    boxes4 = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    cls4 = g.integers(0, 5, (b, 4, m)).astype(np.int32)
    mask4 = g.uniform(size=(b, 4, m)) < 0.7
    mosaic4 = np.arange(b) % 3 != 1
    return {"images4": images4, "boxes4": boxes4, "cls4": cls4,
            "mask4": mask4, "mosaic4": mosaic4}


def _close(got, want):
    img, gt, cls, mask = want
    np.testing.assert_allclose(got[0].numpy(), np.asarray(img), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(gt), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(cls))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(mask))


def test_rgb_jitter_matches_reference():
    img = np.random.default_rng(2).uniform(0, 1, (3, 24, 20, 3)).astype(
        np.float32)
    keys = [jax.random.PRNGKey(k) for k in (0, 5, 11)]
    want = np.stack([np.asarray(JD.rgb_jitter(jnp.asarray(i), k))
                     for i, k in zip(img, keys)])
    hsv = []
    for k in keys:
        kh, ks, kv = jax.random.split(k, 3)
        hsv.append([jax.random.uniform(kh, (), minval=-0.015,
                                       maxval=0.015) * jnp.pi * 2,
                    1.0 + jax.random.uniform(ks, (), minval=-0.7, maxval=0.7),
                    1.0 + jax.random.uniform(kv, (), minval=-0.4,
                                             maxval=0.4)])
    got = PD.rgb_jitter(torch.from_numpy(img),
                        torch.tensor(np.asarray(hsv, np.float32)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_mosaic_matches_reference(seed):
    """``device_mosaic`` on a batch against ``device_mosaic_one`` per
    sample, on its draws: mosaic on and off, flipped and not, with HSV."""
    b, s = 3, 32
    t = _tiles(b, s, seed=seed)
    rng = jax.random.PRNGKey(seed)
    draws = _ref_draws(rng, b, s, 0.5, 0.0)
    want = [JD.device_mosaic_one(
        jnp.asarray(t["images4"][i]), jnp.asarray(t["boxes4"][i]),
        jnp.asarray(t["cls4"][i]), jnp.asarray(t["mask4"][i]), r,
        jnp.asarray(t["mosaic4"][i]), flip_p=0.5, hsv=True)
        for i, r in enumerate(jax.random.split(rng, b))]
    want = [np.stack([np.asarray(w[k]) for w in want]) for k in range(4)]
    th = {k: torch.from_numpy(np.array(v)) for k, v in t.items()}
    got = PD.device_mosaic(th["images4"], th["boxes4"], th["cls4"],
                           th["mask4"], th["mosaic4"], draws, hsv=True)
    _close(got, want)


@pytest.mark.parametrize("mixup_p", [0.0, 0.7])
def test_device_augment_batch_matches_reference(mixup_p):
    b, s = 5, 32
    t = _tiles(b, s, seed=7)
    rng = jax.random.PRNGKey(48)         # mixup coins: 3 of 5 at p 0.7
    want = JD.device_augment_batch({k: jnp.asarray(v) for k, v in t.items()},
                                   rng, flip_p=0.5, hsv=True,
                                   mixup_p=mixup_p)
    draws = _ref_draws(rng, b, s, 0.5, mixup_p)
    if mixup_p:
        assert 0 < int(draws.mix.sum()) < b
    got = PD.device_augment_batch(
        {k: torch.from_numpy(np.array(v)) for k, v in t.items()}, draws,
        hsv=True)
    assert got["gt_boxes"].shape[1] == (8 if mixup_p else 4) * 6
    _close([got[k] for k in ("image", "gt_boxes", "gt_cls", "gt_mask")],
           [want[k] for k in ("image", "gt_boxes", "gt_cls", "gt_mask")])


def test_sample_draws_statistics():
    """The port's sampler has the reference's distributions: offsets
    uniform on [0, S], coins at their rates, gains uniform on their ranges,
    the mixup ratio Beta(32, 32) (mean 1/2, variance 1/260)."""
    n, s = 20000, 64
    gen = torch.Generator().manual_seed(3)
    d = PD.sample_draws(n, s, gen, flip_p=0.3, mixup_p=0.4)

    def near(x, mean, var):
        assert abs(float(x.double().mean()) - mean) < 5 * (var / n) ** 0.5

    assert int(d.oy.min()) == 0 and int(d.oy.max()) == s
    near(d.oy, s / 2, ((s + 1) ** 2 - 1) / 12)
    near(d.ox, s / 2, ((s + 1) ** 2 - 1) / 12)
    near(d.flip, 0.3, 0.21)
    near(d.mix, 0.4, 0.24)
    near(d.mix_r, 0.5, 1 / 260)
    near((d.mix_r - 0.5) ** 2, 1 / 260, 2 / 260 ** 2)
    for col, (lo, hi) in enumerate([(-0.015 * 2 * np.pi, 0.015 * 2 * np.pi),
                                    (0.3, 1.7), (0.6, 1.4)]):
        x = d.hsv[:, col]
        assert lo <= float(x.min()) and float(x.max()) <= hi
        near(x, (lo + hi) / 2, (hi - lo) ** 2 / 12)
    again = PD.sample_draws(n, s, torch.Generator().manual_seed(3),
                            flip_p=0.3, mixup_p=0.4)
    assert torch.equal(again.oy, d.oy) and torch.equal(again.mix_r, d.mix_r)
    with pytest.raises(ValueError, match="mixup_beta"):
        PD.sample_draws(4, s, gen, mixup_p=0.5, mixup_beta=2.5)


def test_device_aug_pipeline_matches_reference(tmp_path):
    """The host half: the reference's coins, tiles and boxes per sample, and
    a ``TrainLoader`` that carries its keys to an augmentable batch."""
    ann, imgs = build_coco_dataset(str(tmp_path), n_images=6, hw=(60, 100))
    p_ds, j_ds = PR.COCODataset(ann, imgs), JR.COCODataset(ann, imgs)
    port = PA.DeviceAugPipeline(p_ds, 64, max_boxes=5, seed=4, mosaic_p=0.5)
    ref = JA.DeviceAugPipeline(j_ds, 64, max_boxes=5, seed=4, mosaic_p=0.5)
    coins = set()
    for i in range(len(p_ds)):
        p, r = port.sample(i, epoch=1), ref.sample(i, epoch=1)
        assert set(p) == set(r)
        coins.add(bool(p["mosaic4"]))
        assert bool(p["mosaic4"]) == bool(r["mosaic4"])
        diff = np.abs(p["images4"].astype(int) - r["images4"].astype(int))
        assert diff.max() <= 1
        np.testing.assert_allclose(p["boxes4"], r["boxes4"], atol=1e-4)
        for k in ("cls4", "mask4"):
            np.testing.assert_array_equal(p[k], r[k])
    assert coins == {True, False}
    loader = TrainLoader(port, 4, seed=4, num_workers=2, device="cpu",
                         keys=TrainLoader.DEVICE_AUG_KEYS)
    batch = next(iter(loader.epoch(0)))
    assert batch["images4"].shape == (4, 4, 64, 64, 3)
    assert batch["mosaic4"].shape == (4,) and batch["mosaic4"].dtype == \
        torch.bool
    out = PD.device_augment_batch(batch, PD.sample_draws(
        4, 64, torch.Generator().manual_seed(0)))
    assert out["image"].shape == (4, 64, 64, 3)
    assert 0.0 <= float(out["image"].min()) and \
        float(out["image"].max()) <= 1.0
    assert out["gt_boxes"].shape == (4, 20, 4)
    # the same batch twice: the draws alone make the difference
    again = PD.device_augment_batch(copy.deepcopy(batch), PD.sample_draws(
        4, 64, torch.Generator().manual_seed(0)))
    assert torch.equal(again["image"], out["image"])


def test_closing_a_loader_stops_its_workers():
    """``close()`` on a batch iterator returns only after its worker
    threads have stopped: no sample starts after it, none is left
    running."""
    started, closed = [], threading.Event()

    class Slow:
        def __len__(self):
            return 48

        def sample(self, i, epoch=0):
            started.append(closed.is_set())
            time.sleep(0.02)
            return {k: np.zeros(1, np.float32) for k in TrainLoader.KEYS}

    base = threading.active_count()
    loader = TrainLoader(Slow(), 8, num_workers=4, prefetch=4, device="cpu")
    for batches in (loader.host_batches(0), loader.epoch(0)):
        next(batches)
        batches.close()
        closed.set()
        assert threading.active_count() == base
        time.sleep(0.1)
        assert not any(started) and threading.active_count() == base
        closed.clear()
