"""Networks (ports livetalking_tpu/models/): conv layers and the
Wav2Lip-256 U-Net."""
