"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W), a frozen copy of ``chip_smoke.py:436-437`` with the bf16
tensor-core rate added. A run prints the card's power limit beside every
share of these."""

BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
