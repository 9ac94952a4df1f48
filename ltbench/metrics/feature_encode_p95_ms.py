"""feature_encode_p95_ms: 95th percentile of the window's ``features.encode`` spans (a
session's Whisper encode in ``WhisperFeatures.run_step``, with the feature coalescer's
wait), in ms."""

from ltbench.spans import p95_ms


def read(run):
    return p95_ms(run, "features.encode")
