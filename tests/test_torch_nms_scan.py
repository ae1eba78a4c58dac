"""The greedy scan of the port's NMS kernels (csrc/nms_scan.cuh), modelled in
numpy at the level of its words, and held on the CPU against the JAX
package's ``nms_mask_jnp`` and the port's ``nms_mask_seq``.

The model packs the plain ``suppression_matrix`` into words, lays the words
out as each kernel's build leaves them, and scans them as the kernel does:
rows go one block of ``bits`` rows at a time (the rows of word r); the
block's diagonal word resolves serially (row k is kept iff its bit is still
clear, and a kept row ORs its diagonal word in); then the kept rows' words
at or right of the diagonal are ORed into ``removed``. Words left of a
block's diagonal word are filled with random bits, as the kernels leave
them unwritten, so a model that read one would disagree. Layouts:

* ``fixpoint32``: 32-bit words, rows spread over the four blocks of an
  ``nms_fixpoint`` cluster (row i in rank i % 4 at local row i // 4), read
  by the kernel's address formula;
* ``mask32``: ``nms_mask``'s 64x64-tile build in uint64 words, tiles left
  of the diagonal unwritten, read as little-endian 32-bit words;
* ``words64``: 64-bit words and 64-row blocks, the other word width.

``nms_mask``'s scan past the lanes' registers (N > 16384) keeps the removed
words in shared memory and walks units of (block, slot) in the kernel's
order: :func:`_shared_scan` models it lane by lane on the same layouts.

Masks are bit masks: every comparison is exact. The inputs carry no IoU on
the threshold, so the two predicates in use (``inter > thr·union`` in the
port, ``inter/union > thr`` in ``nms_mask_jnp``) agree.
"""

import functools
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heltondetection_tpu.ops import nms as JN

from heltondetection_tpu_torch.kernels import KERNELS, build, launch_counts
from heltondetection_tpu_torch.kernels import nms as nms_kernel
from heltondetection_tpu_torch.ops import nms as TN


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# inputs: score-sorted (N, 4) f32 xyxy boxes and a threshold
# ---------------------------------------------------------------------------

def _random(n, seed, size=400.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(4, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _class_offset_padding(n, seed, n_pad):
    rng = np.random.default_rng(seed)
    boxes = _random(n, seed, size=150.0)
    boxes += rng.integers(0, 4, (n, 1)).astype(np.float32) * 8192.0
    boxes[n - n_pad:] = 0.0
    return boxes


def _chain(n):
    """Box i overlaps only i - 1 and i + 1, at IoU 8/12 > 0.65: the greedy
    mask alternates and the chain crosses every block boundary."""
    i = np.arange(n, dtype=np.float32)
    return np.stack([i * 2.0, np.zeros(n), i * 2.0 + 10.0,
                     np.full(n, 10.0)], -1).astype(np.float32)


def _block_first_row(n=256):
    """Row 64 (the first row of 32-bit block 2, 64-bit block 1) is a big
    box. Rows 65..95 of its own block but 80, and every 7th row from 101,
    are copies shifted by 40 px, which it suppresses (IoU 0.667). Row 80
    overlaps each copy at IoU 0.667 but the big box at only 0.429, so it is
    kept only if the removed copies suppress nothing. The rest are small
    boxes far away."""
    boxes = _random(n, 11, size=60.0) + np.float32(1000.0)
    boxes[64] = [0.0, 0.0, 200.0, 200.0]
    for j in [*range(65, 80), *range(81, 96), *range(101, n, 7)]:
        boxes[j] = [40.0, 0.0, 240.0, 200.0]
    boxes[80] = [80.0, 0.0, 280.0, 200.0]
    return boxes


CASES = {
    "random N=1024": lambda: (_random(1024, 0), 0.5),
    "class offset, 300 padding rows, N=1024":
        lambda: (_class_offset_padding(1024, 1, 300), 0.5),
    "1024-deep chain": lambda: (_chain(1024), 0.65),
    "random N=2048": lambda: (_random(2048, 2, size=900.0), 0.6),
    "first row of a block suppresses it and later blocks":
        lambda: (_block_first_row(), 0.65),
    "all boxes identical": lambda: (np.tile(np.array(
        [[10.0, 20.0, 110.0, 90.0]], np.float32), (256, 1)), 0.65),
}


@functools.lru_cache(maxsize=None)
def _references(case):
    """(sup, nms_mask_jnp's mask, nms_mask_seq's mask) for one case."""
    boxes, thr = CASES[case]()
    t = torch.from_numpy(boxes)
    sup = TN.suppression_matrix(t, thr).numpy()
    seq = TN.nms_mask_seq(t, thr).numpy()
    want = np.asarray(jax.jit(lambda b: JN.nms_mask_jnp(b, None, thr))(
        jnp.asarray(boxes)))
    return sup, want, seq


# ---------------------------------------------------------------------------
# the word-level model
# ---------------------------------------------------------------------------

def _pack(sup, bits):
    """(N, N) bool -> (N, N / bits) words; bit k of word w is column
    bits * w + k."""
    n = sup.shape[0]
    weights = np.ones(bits, np.uint64) << np.arange(bits, dtype=np.uint64)
    words = (sup.reshape(n, n // bits, bits).astype(np.uint64)
             * weights).sum(-1, dtype=np.uint64)
    return words.astype(np.uint32 if bits == 32 else np.uint64)


def _junk_left_of(words, row_word, seed):
    """Random bits in every word w < row_word(i) of row i, as a build that
    does not write them leaves them."""
    rng = np.random.default_rng(seed)
    out = words.copy()
    junk = rng.integers(0, np.iinfo(out.dtype).max, out.shape,
                        dtype=out.dtype, endpoint=True)
    cols = np.arange(out.shape[1])[None, :]
    left = cols < row_word(np.arange(out.shape[0]))[:, None]
    out[left] = junk[left]
    return out


def _layout(sup, layout):
    """(bits, load): load(blk, w) -> the bits row words of block blk's rows
    at word w, read from the layout the kernel's build leaves."""
    if layout == "fixpoint32":
        words = _junk_left_of(_pack(sup, 32), lambda i: i // 32, 3)
        ranks = [words[c::4] for c in range(4)]     # rank c: rows c, c+4, ..

        def load(blk, w):
            first = blk * 8                          # 32 rows / 4 ranks
            return np.array([ranks[k % 4][first + k // 4, w]
                             for k in range(32)], np.uint32)
        return 32, load
    if layout == "mask32":
        tiles = _junk_left_of(_pack(sup, 64), lambda i: i // 64, 4)
        words = np.ascontiguousarray(tiles).view("<u4")   # low half first

        def load(blk, w):
            return words[32 * blk:32 * blk + 32, w]
        return 32, load
    words = _junk_left_of(_pack(sup, 64), lambda i: i // 64, 5)

    def load(blk, w):
        return words[64 * blk:64 * blk + 64, w]
    return 64, load


def _block_scan(load, n, bits):
    """The kernels' greedy scan over n rows; returns keep (n,) bool."""
    nwords = n // bits
    removed = [0] * nwords
    for r in range(nwords):
        diag = [int(x) for x in load(r, r)]
        d = removed[r]
        for k in range(bits):                 # the serial diagonal
            if not (d >> k) & 1:
                d |= diag[k]
        kept = [k for k in range(bits) if not (d >> k) & 1]
        for w in range(r, nwords):            # at or right of the diagonal
            rows = load(r, w)
            for k in kept:
                removed[w] |= int(rows[k])
        assert removed[r] == d                # the diagonal lane's OR
    return np.array([not (removed[i // bits] >> (i % bits)) & 1
                     for i in range(n)])


def _shared_scan(load, n, bits):
    """``nms::greedy_scan_shared``: 32 lanes, lane l holding words 32s + l
    (slot s), the removed words in one shared array (word w at index w);
    units (block, slot) in ``nms::advance``'s order, each lane's row words
    of the block loaded only at or right of the block's diagonal word; the
    diagonal lane resolves the diagonal from its own shared word, and every
    lane ORs the kept rows' words into its own word. Returns keep (n,)."""
    words = n // bits
    slots = -(-words // 32)
    dtype = np.uint32 if bits == 32 else np.uint64
    removed = np.zeros(slots * 32, dtype)
    kept, blk, slot = np.zeros(bits, bool), 0, 0
    while blk < words:
        buf = np.zeros((32, bits), dtype)          # lane x row
        for lane in range(32):
            w = 32 * slot + lane
            if blk <= w < words:
                buf[lane] = load(blk, w)
        if slot == blk // 32:
            d = int(removed[blk])
            for k, row in enumerate(buf[blk % 32]):
                if not (d >> k) & 1:
                    d |= int(row)
            kept = np.array([not (d >> k) & 1 for k in range(bits)])
        acc = np.bitwise_or.reduce(buf[:, kept], axis=1) if kept.any() \
            else np.zeros(32, dtype)
        removed[32 * slot:32 * slot + 32] |= acc
        slot += 1
        if slot == slots or 32 * slot >= words:
            blk += 1
            slot = blk // 32
    return np.array([not (int(removed[i // bits]) >> (i % bits)) & 1
                     for i in range(n)])


@pytest.mark.parametrize("layout", ["fixpoint32", "mask32", "words64"])
@pytest.mark.parametrize("case", list(CASES))
def test_shared_scan_matches_greedy(case, layout):
    sup, want, _ = _references(case)
    bits, load = _layout(sup, layout)
    np.testing.assert_array_equal(_shared_scan(load, sup.shape[0], bits),
                                  want)


@pytest.mark.parametrize("layout", ["fixpoint32", "mask32", "words64"])
@pytest.mark.parametrize("case", list(CASES))
def test_block_scan_matches_greedy(case, layout):
    sup, want, seq = _references(case)
    np.testing.assert_array_equal(seq, want)
    bits, load = _layout(sup, layout)
    got = _block_scan(load, sup.shape[0], bits)
    np.testing.assert_array_equal(got, want)
    if case == "1024-deep chain":
        assert got.sum() == 512
    if case == "all boxes identical":
        assert got.sum() == 1 and got[0]
    if case.startswith("first row"):
        copies = [*range(65, 80), *range(81, 96), *range(101, 256, 7)]
        assert got[64] and got[80] and not got[copies].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keep_bytes_from_removed_word(seed):
    """write_keep's nibble spread: eight uint32 stored little-endian are the
    32 keep bytes of one removed word, byte b = 1 - bit b."""
    rng = np.random.default_rng(seed)
    for x in [0, 0xFFFFFFFF, *rng.integers(0, 2**32, 8).tolist()]:
        inv = ~x & 0xFFFFFFFF
        q = []
        for g in range(8):
            nib = (inv >> (4 * g)) & 0xF
            q.append((nib & 1) | ((nib & 2) << 7) | ((nib & 4) << 14)
                     | ((nib & 8) << 21))
        got = np.array(q, "<u4").view(np.uint8)
        want = np.array([1 - ((x >> b) & 1) for b in range(32)], np.uint8)
        np.testing.assert_array_equal(got, want)


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited csrc header rebuilds every library whose source includes
    it, and no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert [p.name for p in build.sources("nms_fixpoint")] == \
        ["nms_fixpoint.cu", "nms_scan.cuh"]
    assert [p.name for p in build.sources("nms_mask")] == \
        ["nms_mask.cu", "nms_scan.cuh"]
    before = {k: build.library_path(k) for k in KERNELS}
    with open(csrc / "nms_scan.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {k: build.library_path(k) for k in KERNELS}
    assert after["nms_fixpoint"] != before["nms_fixpoint"]
    assert after["nms_mask"] != before["nms_mask"]
    assert after["iou_matrix"] == before["iou_matrix"]


@pytest.mark.parametrize("wrapper", ["nms_fixpoint_build", "nms_mask"])
def test_nms_wrappers_take_only_cuda_tensors(wrapper):
    """Each wrapper raises on a CPU tensor before it builds or launches
    anything; the CPU path is the plain version, in ops/nms.py."""
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(nms_kernel, wrapper)(torch.zeros((2, 64, 4)), 0.5)
    assert launch_counts == before
