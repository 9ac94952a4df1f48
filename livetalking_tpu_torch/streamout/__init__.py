"""Output transports (ports livetalking_tpu/streamout/): ``start`` /
``push_video_frame`` / ``push_audio_frame`` / ``get_buffer_size`` (engine
back-pressure) / ``stop``."""

OUTPUT_MODULES = {
    "webrtc": "livetalking_tpu_torch.streamout.webrtc",
    "rtcpush": "livetalking_tpu_torch.streamout.webrtc",
    "rtmp": "livetalking_tpu_torch.streamout.rtmp",
    "virtualcam": "livetalking_tpu_torch.streamout.virtualcam",
    "queue": "livetalking_tpu_torch.streamout.local",
    "null": "livetalking_tpu_torch.streamout.local",
}
