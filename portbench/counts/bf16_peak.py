"""Published bf16 peak of one NVIDIA H100 SXM: dense tensor-core products
of bf16 operands with float32 accumulation (NVIDIA's H100 data sheet, SXM
part, without sparsity, at the 700 W power limit).  A share of it is stated
with the card's power limit beside it."""

BF16_FLOP_PER_S = 989.4e12
