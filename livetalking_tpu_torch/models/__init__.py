"""Networks (ports livetalking_tpu/models/): the lip-sync families'
models (Wav2Lip, MuseTalk's U-Net and VAE, Ultralight, ER-NeRF) and their
audio encoders (Whisper, HuBERT)."""
