"""TTS plugins (ports livetalking_tpu/tts/): a message queue consumed by a
dedicated thread; each plugin synthesizes text to float32 16 kHz mono and
pushes 20 ms chunks into the parent avatar with start/end eventpoints."""

# module paths for BaseAvatar's lazy plugin import, keyed by --tts name;
# the other provider plugins of the reference package come in a later slice
TTS_MODULES = {
    "dummy": "livetalking_tpu_torch.tts.dummy",
}
