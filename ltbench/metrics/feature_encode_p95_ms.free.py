"""feature_encode_p95_ms.free: feature_encode_p95_ms's quantity (95th percentile of the
window's ``features.encode`` spans, in ms) in a free-running cell; for Wav2Lip the span
is a session's mel front-end request in ``MelFeatures.run_step``."""

from ltbench.spans import p95_ms


def read(run):
    return p95_ms(run, "features.encode")
