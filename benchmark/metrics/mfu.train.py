"""The whole train step's share of the card's bf16 peak: the reference's
FLOPs of one step (forward and backward of its matrix products and
convolutions under autograd, counted from shapes) times the window's
steps a second."""

from benchmark.harness.peaks import BF16_FLOP_PER_S


def read(record):
    if record.get("kind") != "train":
        return None
    return 100.0 * record["flops_per_step"] * record["steps_per_s"] / \
        BF16_FLOP_PER_S
