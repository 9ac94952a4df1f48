"""Offline avatar-build pipelines (ports livetalking_tpu/genavatar/; the
reference's ``genavatar`` scripts, SURVEY §2.8): video/images -> per-frame
face boxes -> model-specific avatar directories (wav2lip / musetalk /
ultralight formats). The ER-NeRF build fits a field and waits for the
port's training step."""

from livetalking_tpu_torch.genavatar.pipeline import (  # noqa: F401
    generate_ernerf_avatar,
    generate_musetalk_avatar,
    generate_ultralight_avatar,
    generate_wav2lip_avatar,
)
