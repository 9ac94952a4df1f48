"""Avatar engine + model plugins (ports livetalking_tpu/avatars/).

Plugin module paths keyed by ``--model``, loaded lazily by the app: all
four of the reference's lip-sync families."""

AVATAR_MODULES = {
    "wav2lip": "livetalking_tpu_torch.avatars.wav2lip_avatar",
    "musetalk": "livetalking_tpu_torch.avatars.musetalk_avatar",
    "ultralight": "livetalking_tpu_torch.avatars.ultralight_avatar",
    "ernerf": "livetalking_tpu_torch.avatars.ernerf_avatar",
}
