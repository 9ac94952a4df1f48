"""Cross-session device batching (ports livetalking_tpu/engine/):
``BatchScheduler`` and ``AvatarStore``."""
