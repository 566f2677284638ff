"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
full 700 W power limit; the run records the card's `power.limit` beside
every share).

The fp32 figure is 67 TFLOP/s outside the tensor cores, which counts a
fused multiply-add as two operations. The sweep kernels are built
without multiply-add contraction and issue separate fp32 multiply, add,
min/max and compare instructions, so their peak is one instruction per
fp32 lane per clock: half the data-sheet figure (chip_smoke.py,
PEAK_F32_INSTR_S)."""

PEAK_BYTES_S = 3.35e12
PEAK_F32_INSTR_S = 67e12 / 2
