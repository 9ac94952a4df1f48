"""Training for the avatar families (ports livetalking_tpu/train/): the
MuseTalk U-Net recipe, Wav2Lip (L1 and GAN), SyncNet, Ultralight (L1 and
sync), the data pipeline, optax-style optimizers, and the CLI
(``python -m livetalking_tpu_torch.train``)."""
