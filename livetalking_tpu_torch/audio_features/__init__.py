"""Per-frame acoustic feature extractors feeding the lip-sync models (ports
livetalking_tpu/audio_features/): ingest 20 ms 16 kHz float32 chunks, emit
one device feature batch per ``run_step`` into ``feat_queue`` plus the raw
audio passthrough into ``output_queue``."""
