"""The measurement lab on the card: K1's step split into stream and compute.

    python -m cloudsc_tpu_torch.bench.kernel_lab --modes full init floor
    python -m cloudsc_tpu_torch.bench.overlap_probe
    python -m cloudsc_tpu_torch.bench.dma_probe

`kernel_lab` times the fused step's three bodies on the same pack: `full`
(the physics), `init` (section-1 compute only) and `floor` (the step's exact
I/O with degenerate compute). `overlap_probe` times a synthetic stream
against a synthetic compute chain (stream time S, cache-resident compute
time C, both together T), and `dma_probe` the copy bandwidth against the
length of the contiguous runs. Each prints one JSON record a measurement;
each needs a CUDA device and exits 1 without one.

The measurement entries:

    python -m cloudsc_tpu_torch.bench.bench     # the metric of record
    python -m cloudsc_tpu_torch.bench.sweep     # size grid, weak scaling

`bench` prints the main path's columns/s per chip as one JSON line (the
JAX package's `bench.py`; its skip line without a card); `sweep` runs the
CLI over a grid of sizes, kernels and precisions, or `bench` over 1..N
cards (the JAX package's `bench/sweep.py`).
"""
