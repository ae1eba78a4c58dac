"""The whole eval step's share of the card's bf16 peak: the reference's
FLOPs a frame (matrix products and convolutions, counted from shapes)
times the window's frames a second."""

from benchmark.harness.peaks import BF16_FLOP_PER_S


def read(record):
    if record.get("kind") != "infer":
        return None
    return 100.0 * record["flops_per_img"] * record["img_per_s"] / \
        BF16_FLOP_PER_S
