"""The chip's published peaks, frozen here: NVIDIA's H100 SXM data sheet,
dense rates without sparsity, at the full 700 W power limit. A card set
below 700 W reaches less; each result carries the card's name and
power limit beside the shares computed against these."""

BF16_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12    # HBM3 bytes/s
SOURCE = "NVIDIA H100 SXM data sheet (dense, 700 W)"
