"""Output transports (ports livetalking_tpu/streamout/): ``start`` /
``push_video_frame`` / ``push_audio_frame`` / ``get_buffer_size`` (engine
back-pressure) / ``stop``."""

# webrtc, rtcpush, rtmp and virtualcam come in a later slice
OUTPUT_MODULES = {
    "queue": "livetalking_tpu_torch.streamout.local",
    "null": "livetalking_tpu_torch.streamout.local",
}
