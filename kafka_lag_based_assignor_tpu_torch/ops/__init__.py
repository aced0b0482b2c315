"""Device solve: packing, sorts, the round scan and its CUDA kernel."""
