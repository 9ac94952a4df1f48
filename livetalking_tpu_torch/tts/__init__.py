"""TTS plugins (ports livetalking_tpu/tts/): a message queue consumed by a
dedicated thread; each plugin synthesizes text to float32 16 kHz mono and
pushes 20 ms chunks into the parent avatar with start/end eventpoints;
``flush_talk`` clears the queue and pauses in-flight chunk emission."""

# module paths for BaseAvatar's lazy plugin import, keyed by --tts name; a
# provider whose SDK is missing fails the import of its own module only
TTS_MODULES = {
    "edgetts": "livetalking_tpu_torch.tts.edge",
    "gpt-sovits": "livetalking_tpu_torch.tts.sovits",
    "xtts": "livetalking_tpu_torch.tts.xtts",
    "cosyvoice": "livetalking_tpu_torch.tts.cosyvoice",
    "fishtts": "livetalking_tpu_torch.tts.fish",
    "tencent": "livetalking_tpu_torch.tts.tencent",
    "doubao": "livetalking_tpu_torch.tts.doubao",
    "indextts2": "livetalking_tpu_torch.tts.indextts2",
    "azuretts": "livetalking_tpu_torch.tts.azure",
    "qwentts": "livetalking_tpu_torch.tts.qwentts",
    "omnitts": "livetalking_tpu_torch.tts.omnitts",
    "dummy": "livetalking_tpu_torch.tts.dummy",
}
