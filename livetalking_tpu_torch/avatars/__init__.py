"""Avatar engine + model plugins (ports livetalking_tpu/avatars/).

Plugin module paths keyed by ``--model``, loaded lazily by the app. This
package ports wav2lip and musetalk (bf16/f32) so far; ultralight and ernerf
are queued in ROADMAP.md."""

AVATAR_MODULES = {
    "wav2lip": "livetalking_tpu_torch.avatars.wav2lip_avatar",
    "musetalk": "livetalking_tpu_torch.avatars.musetalk_avatar",
}
