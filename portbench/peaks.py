"""Published peaks of the card the benchmark runs on (NVIDIA's H100 SXM
data sheet, at its 700 W power limit): a share of a roofline is stated
against these, with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
