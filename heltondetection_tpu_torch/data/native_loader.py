"""Native data-loader pipelines: whole batches assembled in C++ by the
loader core (``native/loader_core.cpp``); counterpart of
heltondetection_tpu/data/native_loader.py.

Python draws each sample's random parameters, consuming the
``np.random.Generator`` of (seed, epoch, index) in the reference's order,
and transforms the small box arrays with the helpers of ``data/augment.py``;
every pixel pass (the optional JPEG decode, the mosaic or letterbox render,
the affine warp, the HSV jitter, the flip) runs in one ``hd_pool_run`` call
on a persistent C++ thread pool that releases the GIL. The same (seed,
epoch, index) gives the reference's native pipeline's plan, and so its
pixels, bit for bit (tests/test_torch_port_native_loader.py). The port's
Python pipelines (``TrainPipeline``, ``DeviceAugPipeline``,
``EvalPipeline``) render in torch, not OpenCV, and differ from these by a
few grey levels; boxes, classes and masks are the same arithmetic.

Decode modes:

* default: sources come from ``dataset.load`` (decoded by the reader;
  composes with ``readers.CachedDataset``);
* ``decode_in_pool=True``: readers with ``load_encoded`` (COCO) hand the
  JPEG bytes to the pool, which decodes them with libjpeg (the decoder
  OpenCV wraps; no EXIF rotation, so EXIF-oriented files take the default
  mode). A file whose decoded size disagrees with its annotation is
  refused.

The batch loaders (``data/loader.py``) call ``sample_batch`` with a
:class:`NativePool` they own; ``sample`` renders one sample on the calling
thread.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from heltondetection_tpu_torch.data.augment import (MIXUP_STREAM_TAG,
                                                    affine_boxes,
                                                    affine_params,
                                                    flip_boxes, hsv_params,
                                                    mixup_blend,
                                                    mixup_draws,
                                                    mosaic_boxes)
from heltondetection_tpu_torch.data.loader import WAIT_S
from heltondetection_tpu_torch.data.readers import drop_ignore_boxes
from heltondetection_tpu_torch.native import HdPlan, get_loader_lib


def native_loader_available() -> bool:
    """Whether the loader core builds and loads here (built at the first
    call; ``native.loader_build_error()`` says why not)."""
    return get_loader_lib() is not None


class NativePool:
    """A persistent C++ worker pool; one per loader. ``run`` is serialized
    by a lock: ``hd_pool_run`` is not reentrant."""

    def __init__(self, num_threads: Optional[int] = None):
        self._lib = get_loader_lib()
        if self._lib is None:
            raise RuntimeError("the native loader core is not available")
        n = num_threads or min(32, (os.cpu_count() or 1) * 2)
        self._handle = self._lib.hd_pool_create(int(n))
        self._run_lock = threading.Lock()

    def run(self, plans: "ctypes.Array[HdPlan]", n: int) -> None:
        with self._run_lock:
            self._lib.hd_pool_run(self._handle, plans, n)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.hd_pool_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover (interpreter-exit ordering)
        try:
            self.close()
        except Exception:
            pass


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


_PLAN_ERRORS = {
    1: "JPEG decode failed",
    2: "no pixel source (neither decoded image nor JPEG bytes)",
    3: "native exception (e.g. degenerate image dims in cv::resize)",
    4: "decoded JPEG dims disagree with annotation metadata (mis-annotated "
       "or EXIF-rotated file; use the decoded path for EXIF sources)",
}


def _check_status(status: int, idx) -> None:
    if status != 0:
        reason = _PLAN_ERRORS.get(status, "unknown error")
        raise RuntimeError(f"native loader plan failed for index {idx}: "
                           f"{reason} (status {status})")


def _dims(raw: Dict) -> Tuple[int, int]:
    if "image" in raw:
        return raw["image"].shape[:2]
    return raw["height"], raw["width"]


def _set_src(p: HdPlan, t: int, raw: Dict, keep: List) -> None:
    """Point plan tile ``t`` at a decoded RGB buffer or at JPEG bytes;
    ``keep`` holds the buffer while the plan may run."""
    if "image" in raw:
        img = np.ascontiguousarray(raw["image"])
        keep.append(img)
        p.src[t] = _ptr(img)
        p.sh[t], p.sw[t] = img.shape[:2]
    else:
        buf = raw["jpeg"]
        keep.append(buf)
        p.jpeg[t] = _ptr(buf)
        p.jlen[t] = buf.nbytes
        p.sh[t], p.sw[t] = raw["height"], raw["width"]


def _letterbox_plan(raw: Dict, s: int, out: np.ndarray, keep: List
                    ) -> Tuple[HdPlan, float, int, int]:
    """The plan that letterboxes ``raw`` into ``out`` (S, S, 3), with the
    scale and the left and top pads of its geometry."""
    p = HdPlan()
    p.mode = 0
    p.n_tiles = 1
    p.S = s
    p.pad_value = 114
    p.out = _ptr(out)
    keep.append(out)
    _set_src(p, 0, raw, keep)
    h, w = _dims(raw)
    scale = min(s / h, s / w)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    return p, scale, (s - nw) // 2, (s - nh) // 2


class _NativePipelineBase:
    """What the native pipelines share: the library, the decode mode, the
    fetch of raw samples through a prefetch dict, and a persistent
    executor for that prefetch (a new one per batch would start and stop
    16 threads on the loader's hot path)."""

    def _init_native(self, dataset, decode_in_pool: bool) -> None:
        self.ds = dataset
        self.decode_in_pool = (decode_in_pool
                               and hasattr(dataset, "load_encoded"))
        self._lib = get_loader_lib()
        if self._lib is None:
            raise RuntimeError("the native loader core is not available")
        self._fetch_pool: Optional[ThreadPoolExecutor] = None

    def __len__(self):
        return len(self.ds)

    def _fetch(self, idx: int,
               cache: Optional[Dict[int, Dict]] = None) -> Dict:
        """The raw sample: its decoded image (default) or its JPEG bytes
        and size. ``cache`` is a prefetch dict; a miss loads directly."""
        if cache is not None and idx in cache:
            return cache[idx]
        if self.decode_in_pool:
            return self.ds.load_encoded(idx)
        return self.ds.load(idx)

    def _prefetch(self, ids) -> Dict[int, Dict]:
        """Fetch raw samples on threads (image decoding releases the GIL),
        so the serial planning only reads memory."""
        ids = list(ids)
        if len(ids) <= 1:
            return {j: self._fetch(j) for j in ids}
        if self._fetch_pool is None:
            self._fetch_pool = ThreadPoolExecutor(
                16, thread_name_prefix="hd-fetch")
        return dict(zip(ids, self._fetch_pool.map(self._fetch, ids,
                                                  timeout=WAIT_S)))

    def close(self) -> None:
        if getattr(self, "_fetch_pool", None) is not None:
            self._fetch_pool.shutdown(wait=False)
            self._fetch_pool = None

    def __del__(self):  # pragma: no cover (interpreter-exit ordering)
        try:
            self.close()
        except Exception:
            pass


class NativeTrainPipeline(_NativePipelineBase):
    """The train pipeline with its pixels in C++: mosaic(p) → affine → HSV
    → flip(p) (letterbox without mosaic) → optional mixup(p) with a
    second sample, cxcywh targets padded to ``max_boxes`` with a mask; the
    draws of ``data.augment.TrainPipeline``.

    ``plan(idx, epoch, out)`` draws the sample's parameters, computes its
    targets and returns the plans that render its pixels into ``out``;
    ``sample_batch`` runs a whole batch's plans in one pool call, and
    ``sample`` one sample's on the calling thread."""

    def __init__(self, dataset, img_size: int, *, mosaic_p: float = 0.5,
                 hsv: bool = True, flip_p: float = 0.5, max_boxes: int = 128,
                 seed: int = 0, affine: bool = True,
                 affine_scale: float = 0.5, affine_translate: float = 0.1,
                 degrees: float = 0.0, mixup_p: float = 0.0,
                 decode_in_pool: bool = False):
        self.img_size = img_size
        self.mosaic_p = mosaic_p
        self.hsv = hsv
        self.flip_p = flip_p
        self.max_boxes = max_boxes
        self.seed = seed
        self.affine = affine
        self.affine_scale = affine_scale
        self.affine_translate = affine_translate
        self.degrees = degrees
        self.mixup_p = mixup_p
        self._init_native(dataset, decode_in_pool)

    def _tile_ids(self, idx: int, rng: np.random.Generator) -> List[int]:
        """The mosaic coin and the three tile picks of ``_plan_one``."""
        if rng.uniform() < self.mosaic_p and len(self.ds) >= 4:
            return [idx] + [int(j) for j in rng.integers(0, len(self.ds), 3)]
        return [idx]

    def sample_ids(self, idx: int, epoch: int) -> List[int]:
        """The dataset indices ``plan(idx, epoch)`` reads, from a replay of
        the first draws of ``plan`` (mixup's, the mosaic coin and tiles,
        then the partner's): it must stay in step with ``plan``."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        partner, _ = mixup_draws(rng, self.mixup_p, len(self.ds))
        ids = self._tile_ids(idx, rng)
        if partner is not None:
            rng2 = np.random.default_rng(np.random.SeedSequence(
                [self.seed, epoch, partner, MIXUP_STREAM_TAG]))
            ids += self._tile_ids(partner, rng2)
        return ids

    def plan(self, idx: int, epoch: int, out: np.ndarray,
             cache: Optional[Dict[int, Dict]] = None
             ) -> Tuple[List[HdPlan], Dict[str, Any], List, float]:
        """(plans, targets, keepalive, blend_r). ``out`` is the (S, S, 3)
        uint8 slot the pool renders into; ``keepalive`` holds the buffers
        the plans point at. With mixup a second plan renders the partner
        into a scratch buffer (``keepalive[-1]``), which the caller blends
        in after the pool ran: ``mixup_blend(out, scratch, blend_r)``."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        partner, blend_r = mixup_draws(rng, self.mixup_p, len(self.ds))
        p, boxes, classes, keep = self._plan_one(idx, rng, out, cache)
        plans = [p]
        if partner is not None:
            scratch = np.empty_like(out)
            rng2 = np.random.default_rng(np.random.SeedSequence(
                [self.seed, epoch, partner, MIXUP_STREAM_TAG]))
            p2, boxes2, classes2, keep2 = self._plan_one(
                partner, rng2, scratch, cache)
            plans.append(p2)
            keep += keep2 + [scratch]
            boxes = np.concatenate([boxes, boxes2], axis=0)
            classes = np.concatenate([classes, classes2], axis=0)
        else:
            blend_r = 1.0

        m = self.max_boxes
        gt = np.zeros((m, 4), np.float32)
        cl = np.zeros((m,), np.int32)
        mask = np.zeros((m,), bool)
        n = min(len(classes), m)
        if n:
            b = boxes[:n]
            gt[:n, 0] = (b[:, 0] + b[:, 2]) / 2
            gt[:n, 1] = (b[:, 1] + b[:, 3]) / 2
            gt[:n, 2] = b[:, 2] - b[:, 0]
            gt[:n, 3] = b[:, 3] - b[:, 1]
            cl[:n] = classes[:n]
            mask[:n] = True
        targets = {"gt_boxes": gt, "gt_cls": cl, "gt_mask": mask}
        return plans, targets, keep, blend_r

    def _plan_one(self, idx: int, rng: np.random.Generator, out: np.ndarray,
                  cache: Optional[Dict[int, Dict]] = None
                  ) -> Tuple[HdPlan, np.ndarray, np.ndarray, List]:
        """One sample's plan, drawing from ``rng`` in the order of
        ``TrainPipeline._augment_one``: (plan, boxes, classes, keepalive)."""
        s = self.img_size
        if rng.uniform() < self.mosaic_p and len(self.ds) >= 4:
            others = rng.integers(0, len(self.ds), 3)
            raws = [drop_ignore_boxes(self._fetch(idx, cache))] + [
                drop_ignore_boxes(self._fetch(int(j), cache))
                for j in others]
            p = HdPlan()
            p.S = s
            p.pad_value = 114
            p.out = _ptr(out)
            keep: List = [out]
            p.mode = 1
            p.n_tiles = 4
            # mosaic4's draws, in its order
            p.yc = int(rng.uniform(0.5 * s, 1.5 * s))
            p.xc = int(rng.uniform(0.5 * s, 1.5 * s))
            for t, raw in enumerate(raws):
                _set_src(p, t, raw, keep)
            boxes, classes = mosaic_boxes(raws, s, p.xc, p.yc)
            if self.affine:
                rot, sc = affine_params(
                    rng, s, s, degrees=self.degrees,
                    translate=self.affine_translate, scale=self.affine_scale)
                p.do_affine = 1
                rot64 = np.ascontiguousarray(rot, np.float64)
                ctypes.memmove(p.m, rot64.ctypes.data, 6 * 8)
                boxes, classes = affine_boxes(boxes, classes, rot, sc, s, s)
        else:
            raw = drop_ignore_boxes(self._fetch(idx, cache))
            keep = []
            p, scale, left, top = _letterbox_plan(raw, s, out, keep)
            boxes = raw["boxes"]
            if len(boxes):
                boxes = boxes * scale + np.array([left, top, left, top],
                                                 np.float32)
            classes = raw["classes"]
        if self.hsv:
            r = hsv_params(rng)
            p.do_hsv = 1
            p.r0, p.r1, p.r2 = float(r[0]), float(r[1]), float(r[2])
        if rng.uniform() < self.flip_p:
            p.do_flip = 1
            boxes = flip_boxes(boxes, s)
        return p, np.asarray(boxes, np.float32).reshape(-1, 4), \
            np.asarray(classes).reshape(-1), keep

    def sample(self, idx: int, epoch: int = 0) -> Dict:
        """One sample, rendered on the calling thread."""
        out = np.empty((self.img_size, self.img_size, 3), np.uint8)
        plans, targets, keep, blend_r = self.plan(idx, epoch, out)
        for p in plans:
            self._lib.hd_run_plan(ctypes.byref(p))
            _check_status(p.status, idx)
        if len(plans) == 2:
            out[...] = mixup_blend(out, keep[-1], blend_r)
        return {"image": out, **targets}

    def sample_batch(self, idxs: Sequence[int], epoch: int,
                     pool: NativePool) -> Dict[str, np.ndarray]:
        """A whole batch in one pool call (mixup partners are extra plans
        of the same call, blended on the host after it)."""
        s = self.img_size
        images = np.empty((len(idxs), s, s, 3), np.uint8)
        plan_list: List[HdPlan] = []
        owners: List[int] = []
        blends: List[Tuple[int, np.ndarray, float]] = []
        keeps: List = []
        tgt: List[Dict] = []
        cache = self._prefetch({j for idx in idxs
                                for j in self.sample_ids(int(idx), epoch)})
        for i, idx in enumerate(idxs):
            ps, targets, keep, blend_r = self.plan(int(idx), epoch,
                                                   images[i], cache)
            plan_list.extend(ps)
            owners.extend([int(idx)] * len(ps))
            if len(ps) == 2:
                blends.append((i, keep[-1], blend_r))
            keeps.append(keep)
            tgt.append(targets)
        plans = (HdPlan * len(plan_list))(*plan_list)
        pool.run(plans, len(plan_list))
        for p, owner in zip(plans, owners):
            _check_status(p.status, owner)
        for i, scratch, blend_r in blends:
            images[i] = mixup_blend(images[i], scratch, blend_r)
        return {"image": images,
                **{k: np.stack([t[k] for t in tgt])
                   for k in ("gt_boxes", "gt_cls", "gt_mask")}}


class NativeEvalPipeline(_NativePipelineBase):
    """Eval preprocessing in C++: the letterbox alone, with the metadata
    of its inverse (``data.augment.EvalPipeline``'s samples)."""

    def __init__(self, dataset, img_size: int, *,
                 decode_in_pool: bool = False):
        self.img_size = img_size
        self._init_native(dataset, decode_in_pool)

    def plan(self, idx: int, out: np.ndarray,
             cache: Optional[Dict[int, Dict]] = None
             ) -> Tuple[HdPlan, Dict[str, Any], List]:
        """(plan, metadata, keepalive) of sample ``idx`` rendered into
        ``out``."""
        raw = self._fetch(idx, cache)
        keep: List = []
        p, scale, left, top = _letterbox_plan(raw, self.img_size, out, keep)
        meta = {"img_id": raw["img_id"], "scale": scale,
                "pad_x": float(left), "pad_y": float(top),
                "orig_hw": _dims(raw)}
        return p, meta, keep

    def sample(self, idx: int) -> Dict:
        out = np.empty((self.img_size, self.img_size, 3), np.uint8)
        p, meta, keep = self.plan(idx, out)
        self._lib.hd_run_plan(ctypes.byref(p))
        _check_status(p.status, idx)
        return {"image": out, **meta}

    def sample_batch(self, idxs: Sequence[int], pool: NativePool
                     ) -> List[Dict]:
        """The samples of ``idxs``, rendered in one pool call."""
        s = self.img_size
        images = np.empty((len(idxs), s, s, 3), np.uint8)
        plans = (HdPlan * len(idxs))()
        keeps: List = []
        metas: List[Dict] = []
        cache = self._prefetch({int(i) for i in idxs})
        for i, idx in enumerate(idxs):
            p, meta, keep = self.plan(int(idx), images[i], cache)
            plans[i] = p
            keeps.append(keep)
            metas.append(meta)
        pool.run(plans, len(idxs))
        for i, idx in enumerate(idxs):
            _check_status(plans[i].status, idx)
        return [{"image": images[i], **metas[i]} for i in range(len(idxs))]


class NativeDeviceAugPipeline(_NativePipelineBase):
    """The host half of the on-device augmentation in C++
    (``data.augment.DeviceAugPipeline``'s samples and draws): per sample
    the mosaic coin, then the sample and, when the coin fires, three
    seeded-random others, each letterboxed into a (4, S, S, 3) uint8
    stack (unused tiles grey 114); every other random choice is made on
    the card (``data/device_aug.py``)."""

    def __init__(self, dataset, img_size: int, *, max_boxes: int = 32,
                 seed: int = 0, mosaic_p: float = 1.0,
                 decode_in_pool: bool = False):
        self.img_size = img_size
        self.max_boxes = max_boxes
        self.seed = seed
        self.mosaic_p = mosaic_p
        self._init_native(dataset, decode_in_pool)

    def sample_ids(self, idx: int, epoch: int) -> List[int]:
        """The indices ``plan`` reads (see
        ``NativeTrainPipeline.sample_ids``)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        if rng.uniform() < self.mosaic_p:
            return [idx] + [int(j) for j in rng.integers(0, len(self.ds), 3)]
        return [idx]

    def plan(self, idx: int, epoch: int, out4: np.ndarray,
             cache: Optional[Dict[int, Dict]] = None
             ) -> Tuple[List[HdPlan], Dict[str, np.ndarray], List]:
        """(plans, targets, keepalive) rendering into ``out4``, (4, S, S,
        3) uint8 filled with 114."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        s, m = self.img_size, self.max_boxes
        use_mosaic = bool(rng.uniform() < self.mosaic_p)
        ids = [idx]
        if use_mosaic:
            ids += [int(j) for j in rng.integers(0, len(self.ds), 3)]
        boxes4 = np.zeros((4, m, 4), np.float32)
        cls4 = np.zeros((4, m), np.int32)
        mask4 = np.zeros((4, m), bool)
        plans: List[HdPlan] = []
        keep: List = []
        for t, j in enumerate(ids):
            raw = drop_ignore_boxes(self._fetch(j, cache))
            p, scale, left, top = _letterbox_plan(raw, s, out4[t], keep)
            n = min(len(raw["classes"]), m)
            if n:
                boxes4[t, :n] = raw["boxes"][:n] * scale + np.array(
                    [left, top, left, top], np.float32)
                cls4[t, :n] = raw["classes"][:n]
                mask4[t, :n] = True
            plans.append(p)
        targets = {"boxes4": boxes4, "cls4": cls4, "mask4": mask4,
                   "mosaic4": np.asarray(use_mosaic)}
        return plans, targets, keep

    def sample(self, idx: int, epoch: int = 0) -> Dict:
        out4 = np.full((4, self.img_size, self.img_size, 3), 114, np.uint8)
        plans, targets, keep = self.plan(idx, epoch, out4)
        for p in plans:
            self._lib.hd_run_plan(ctypes.byref(p))
            _check_status(p.status, idx)
        return {"images4": out4, **targets}

    def sample_batch(self, idxs: Sequence[int], epoch: int,
                     pool: NativePool) -> Dict[str, np.ndarray]:
        """A whole batch in one pool call."""
        s = self.img_size
        images = np.full((len(idxs), 4, s, s, 3), 114, np.uint8)
        all_plans: List[HdPlan] = []
        owners: List[int] = []
        keeps: List = []
        tgt: List[Dict] = []
        cache = self._prefetch({j for idx in idxs
                                for j in self.sample_ids(int(idx), epoch)})
        for i, idx in enumerate(idxs):
            plans, targets, keep = self.plan(int(idx), epoch, images[i],
                                             cache)
            all_plans.extend(plans)
            owners.extend([int(idx)] * len(plans))
            keeps.append(keep)
            tgt.append(targets)
        arr = (HdPlan * len(all_plans))(*all_plans)
        pool.run(arr, len(all_plans))
        for p, owner in zip(arr, owners):
            _check_status(p.status, owner)
        return {"images4": images,
                **{k: np.stack([t[k] for t in tgt])
                   for k in ("boxes4", "cls4", "mask4", "mosaic4")}}
