"""Device ops (ports livetalking_tpu/ops/): the mel front-end, the
paste-back with its CUDA kernel, and the kernel build."""
