"""Host-side utilities (ports livetalking_tpu/utils/): logging, images,
audio decode/resample, lifecycle, device selection."""
