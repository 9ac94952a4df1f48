// Native A/V runtime of livetalking_tpu_torch (a copy of
// livetalking_tpu/native/avmux.cpp; host code, no kernel).
//
// One module built on the ffmpeg libraries:
//   - an RTMP pusher: ltav_open("rtmp://...", "flv", ...) pushes h264+aac
//     over RTMP (streamout/rtmp.py);
//   - session recording: ltav_open("file.mp4", "mp4", ...) muxes the same
//     streams to disk in one pass (avatars/base_avatar.py);
//   - in-memory audio decode (any container libavformat can probe) to
//     mono float32 at a target rate (utils/audio.py, for compressed TTS
//     payloads such as edge-tts's MP3).
//
// Built by native/__init__.py with g++ and pkg-config into build/native/.
// C ABI only (ctypes-friendly); no Python headers needed.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/audio_fifo.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

namespace {

void set_err(char* errbuf, int errlen, const std::string& msg) {
  if (errbuf && errlen > 0) {
    snprintf(errbuf, errlen, "%s", msg.c_str());
  }
}

std::string av_errstr(int err) {
  char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
  av_strerror(err, buf, sizeof(buf));
  return std::string(buf);
}

}  // namespace

struct LtavMuxer {
  AVFormatContext* fmt = nullptr;
  // video
  AVStream* vstream = nullptr;
  AVCodecContext* venc = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* vframe = nullptr;
  int64_t vpts = 0;
  int width = 0, height = 0, fps = 25;
  // audio
  AVStream* astream = nullptr;
  AVCodecContext* aenc = nullptr;
  SwrContext* swr = nullptr;
  AVAudioFifo* fifo = nullptr;
  int64_t apts = 0;
  int sample_rate = 16000;
  bool header_written = false;
};

static int write_packet(LtavMuxer* m, AVCodecContext* enc, AVStream* stream) {
  AVPacket* pkt = av_packet_alloc();
  int ret = 0;
  while ((ret = avcodec_receive_packet(enc, pkt)) == 0) {
    av_packet_rescale_ts(pkt, enc->time_base, stream->time_base);
    pkt->stream_index = stream->index;
    ret = av_interleaved_write_frame(m->fmt, pkt);
    if (ret < 0) break;
  }
  av_packet_free(&pkt);
  return (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) ? 0 : ret;
}

extern "C" {

LtavMuxer* ltav_open(const char* url, const char* format, int width, int height,
                     int fps, int sample_rate, char* errbuf, int errlen) {
  auto* m = new LtavMuxer();
  m->width = width;
  m->height = height;
  m->fps = fps;
  m->sample_rate = sample_rate;

  int ret = avformat_alloc_output_context2(&m->fmt, nullptr,
                                           (format && format[0]) ? format : nullptr, url);
  if (ret < 0 || !m->fmt) {
    set_err(errbuf, errlen, "alloc_output_context: " + av_errstr(ret));
    delete m;
    return nullptr;
  }

  // ---- video encoder: prefer h264, degrade gracefully ----
  const AVCodec* vcodec = nullptr;
  for (const char* name : {"libx264", "libopenh264", "h264", "mpeg4", "flv"}) {
    vcodec = avcodec_find_encoder_by_name(name);
    if (vcodec) break;
  }
  if (!vcodec) vcodec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!vcodec) {
    set_err(errbuf, errlen, "no usable video encoder in libavcodec");
    delete m;
    return nullptr;
  }
  m->venc = avcodec_alloc_context3(vcodec);
  m->venc->width = width;
  m->venc->height = height;
  m->venc->time_base = AVRational{1, fps};
  m->venc->framerate = AVRational{fps, 1};
  m->venc->pix_fmt = AV_PIX_FMT_YUV420P;
  m->venc->gop_size = fps * 2;
  m->venc->bit_rate = 2'000'000;
  if (m->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    m->venc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (!strcmp(vcodec->name, "libx264")) {
    av_opt_set(m->venc->priv_data, "preset", "veryfast", 0);
    av_opt_set(m->venc->priv_data, "tune", "zerolatency", 0);
  }
  if ((ret = avcodec_open2(m->venc, vcodec, nullptr)) < 0) {
    set_err(errbuf, errlen, std::string("open video encoder ") + vcodec->name +
                                ": " + av_errstr(ret));
    delete m;
    return nullptr;
  }
  m->vstream = avformat_new_stream(m->fmt, nullptr);
  m->vstream->time_base = m->venc->time_base;
  avcodec_parameters_from_context(m->vstream->codecpar, m->venc);

  m->sws = sws_getContext(width, height, AV_PIX_FMT_BGR24, width, height,
                          AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr, nullptr, nullptr);
  m->vframe = av_frame_alloc();
  m->vframe->format = AV_PIX_FMT_YUV420P;
  m->vframe->width = width;
  m->vframe->height = height;
  av_frame_get_buffer(m->vframe, 0);

  // ---- audio encoder: native aac ----
  const AVCodec* acodec = avcodec_find_encoder_by_name("aac");
  if (!acodec) acodec = avcodec_find_encoder(AV_CODEC_ID_AAC);
  m->aenc = avcodec_alloc_context3(acodec);
  m->aenc->sample_rate = sample_rate;
  m->aenc->sample_fmt = AV_SAMPLE_FMT_FLTP;
#if LIBAVUTIL_VERSION_MAJOR >= 57
  av_channel_layout_default(&m->aenc->ch_layout, 1);
#else
  m->aenc->channels = 1;
  m->aenc->channel_layout = AV_CH_LAYOUT_MONO;
#endif
  m->aenc->bit_rate = 64'000;
  m->aenc->time_base = AVRational{1, sample_rate};
  if (m->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    m->aenc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if ((ret = avcodec_open2(m->aenc, acodec, nullptr)) < 0) {
    set_err(errbuf, errlen, "open aac encoder: " + av_errstr(ret));
    delete m;
    return nullptr;
  }
  m->astream = avformat_new_stream(m->fmt, nullptr);
  m->astream->time_base = AVRational{1, sample_rate};
  avcodec_parameters_from_context(m->astream->codecpar, m->aenc);

  // s16 interleaved mono -> fltp
  m->swr = swr_alloc();
#if LIBAVUTIL_VERSION_MAJOR >= 57
  AVChannelLayout mono;
  av_channel_layout_default(&mono, 1);
  av_opt_set_chlayout(m->swr, "in_chlayout", &mono, 0);
  av_opt_set_chlayout(m->swr, "out_chlayout", &mono, 0);
#else
  av_opt_set_int(m->swr, "in_channel_layout", AV_CH_LAYOUT_MONO, 0);
  av_opt_set_int(m->swr, "out_channel_layout", AV_CH_LAYOUT_MONO, 0);
#endif
  av_opt_set_int(m->swr, "in_sample_rate", sample_rate, 0);
  av_opt_set_int(m->swr, "out_sample_rate", sample_rate, 0);
  av_opt_set_sample_fmt(m->swr, "in_sample_fmt", AV_SAMPLE_FMT_S16, 0);
  av_opt_set_sample_fmt(m->swr, "out_sample_fmt", AV_SAMPLE_FMT_FLTP, 0);
  swr_init(m->swr);
  m->fifo = av_audio_fifo_alloc(AV_SAMPLE_FMT_FLTP, 1, sample_rate);

  if (!(m->fmt->oformat->flags & AVFMT_NOFILE)) {
    if ((ret = avio_open(&m->fmt->pb, url, AVIO_FLAG_WRITE)) < 0) {
      set_err(errbuf, errlen, "avio_open: " + av_errstr(ret));
      delete m;
      return nullptr;
    }
  }
  if ((ret = avformat_write_header(m->fmt, nullptr)) < 0) {
    set_err(errbuf, errlen, "write_header: " + av_errstr(ret));
    delete m;
    return nullptr;
  }
  m->header_written = true;
  return m;
}

int ltav_write_video(LtavMuxer* m, const uint8_t* bgr) {
  if (!m || !m->venc) return -1;
  const uint8_t* src[1] = {bgr};
  int stride[1] = {3 * m->width};
  av_frame_make_writable(m->vframe);
  sws_scale(m->sws, src, stride, 0, m->height, m->vframe->data, m->vframe->linesize);
  m->vframe->pts = m->vpts++;
  int ret = avcodec_send_frame(m->venc, m->vframe);
  if (ret < 0) return ret;
  return write_packet(m, m->venc, m->vstream);
}

int ltav_write_audio(LtavMuxer* m, const int16_t* pcm, int nsamples) {
  if (!m || !m->aenc) return -1;
  // convert to fltp into the fifo
  std::vector<float> buf(nsamples);
  uint8_t* out[1] = {reinterpret_cast<uint8_t*>(buf.data())};
  const uint8_t* in[1] = {reinterpret_cast<const uint8_t*>(pcm)};
  int got = swr_convert(m->swr, out, nsamples, in, nsamples);
  if (got < 0) return got;
  av_audio_fifo_write(m->fifo, reinterpret_cast<void**>(out), got);

  const int frame_size = m->aenc->frame_size > 0 ? m->aenc->frame_size : 1024;
  while (av_audio_fifo_size(m->fifo) >= frame_size) {
    AVFrame* af = av_frame_alloc();
    af->nb_samples = frame_size;
    af->format = AV_SAMPLE_FMT_FLTP;
    af->sample_rate = m->sample_rate;
#if LIBAVUTIL_VERSION_MAJOR >= 57
    av_channel_layout_default(&af->ch_layout, 1);
#else
    af->channels = 1;
    af->channel_layout = AV_CH_LAYOUT_MONO;
#endif
    av_frame_get_buffer(af, 0);
    av_audio_fifo_read(m->fifo, reinterpret_cast<void**>(af->data), frame_size);
    af->pts = m->apts;
    m->apts += frame_size;
    int ret = avcodec_send_frame(m->aenc, af);
    av_frame_free(&af);
    if (ret < 0) return ret;
    ret = write_packet(m, m->aenc, m->astream);
    if (ret < 0) return ret;
  }
  return 0;
}

int ltav_close(LtavMuxer* m) {
  if (!m) return -1;
  int ret = 0;
  if (m->header_written) {
    // drain the audio fifo tail (< frame_size samples would otherwise be
    // dropped, truncating up to ~64 ms off every recording): pad the last
    // partial frame with silence and encode it before flushing
    if (m->aenc && m->fifo) {
      int remaining = av_audio_fifo_size(m->fifo);
      if (remaining > 0) {
        const int frame_size = m->aenc->frame_size > 0 ? m->aenc->frame_size : 1024;
        AVFrame* af = av_frame_alloc();
        af->nb_samples = frame_size;
        af->format = AV_SAMPLE_FMT_FLTP;
        af->sample_rate = m->sample_rate;
#if LIBAVUTIL_VERSION_MAJOR >= 57
        av_channel_layout_default(&af->ch_layout, 1);
#else
        af->channels = 1;
        af->channel_layout = AV_CH_LAYOUT_MONO;
#endif
        av_frame_get_buffer(af, 0);
        std::memset(af->data[0], 0, frame_size * sizeof(float));
        av_audio_fifo_read(m->fifo, reinterpret_cast<void**>(af->data), remaining);
        af->pts = m->apts;
        m->apts += frame_size;
        if (avcodec_send_frame(m->aenc, af) >= 0)
          write_packet(m, m->aenc, m->astream);
        av_frame_free(&af);
      }
    }
    // flush encoders
    if (m->venc) {
      avcodec_send_frame(m->venc, nullptr);
      write_packet(m, m->venc, m->vstream);
    }
    if (m->aenc) {
      avcodec_send_frame(m->aenc, nullptr);
      write_packet(m, m->aenc, m->astream);
    }
    ret = av_write_trailer(m->fmt);
  }
  if (m->sws) sws_freeContext(m->sws);
  if (m->vframe) av_frame_free(&m->vframe);
  if (m->venc) avcodec_free_context(&m->venc);
  if (m->aenc) avcodec_free_context(&m->aenc);
  if (m->swr) swr_free(&m->swr);
  if (m->fifo) av_audio_fifo_free(m->fifo);
  if (m->fmt) {
    if (!(m->fmt->oformat->flags & AVFMT_NOFILE) && m->fmt->pb) avio_closep(&m->fmt->pb);
    avformat_free_context(m->fmt);
  }
  delete m;
  return ret;
}

// ---------------------------------------------------------------------------
// in-memory audio decode -> mono float32 @ target_sr
// ---------------------------------------------------------------------------

struct MemCtx {
  const uint8_t* data;
  int size;
  int pos;
};

static int mem_read(void* opaque, uint8_t* buf, int buf_size) {
  auto* c = static_cast<MemCtx*>(opaque);
  int n = c->size - c->pos;
  if (n <= 0) return AVERROR_EOF;
  if (n > buf_size) n = buf_size;
  memcpy(buf, c->data + c->pos, n);
  c->pos += n;
  return n;
}

static int64_t mem_seek(void* opaque, int64_t offset, int whence) {
  auto* c = static_cast<MemCtx*>(opaque);
  if (whence == AVSEEK_SIZE) return c->size;
  int64_t pos = offset;
  if (whence == SEEK_CUR) pos += c->pos;
  if (whence == SEEK_END) pos += c->size;
  if (pos < 0 || pos > c->size) return -1;
  c->pos = static_cast<int>(pos);
  return pos;
}

float* ltav_decode_audio(const uint8_t* data, int len, int target_sr,
                         int* out_len, char* errbuf, int errlen) {
  *out_len = 0;
  MemCtx mem{data, len, 0};
  constexpr int kBufSize = 1 << 16;
  uint8_t* iobuf = static_cast<uint8_t*>(av_malloc(kBufSize));
  AVIOContext* avio =
      avio_alloc_context(iobuf, kBufSize, 0, &mem, mem_read, nullptr, mem_seek);
  AVFormatContext* fmt = avformat_alloc_context();
  fmt->pb = avio;
  int ret = avformat_open_input(&fmt, nullptr, nullptr, nullptr);
  if (ret < 0) {
    set_err(errbuf, errlen, "open_input: " + av_errstr(ret));
    av_freep(&avio->buffer);
    avio_context_free(&avio);
    return nullptr;
  }
  avformat_find_stream_info(fmt, nullptr);
  int sidx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  if (sidx < 0) {
    set_err(errbuf, errlen, "no audio stream");
    avformat_close_input(&fmt);
    av_freep(&avio->buffer);
    avio_context_free(&avio);
    return nullptr;
  }
  AVStream* st = fmt->streams[sidx];
  const AVCodec* dec = avcodec_find_decoder(st->codecpar->codec_id);
  AVCodecContext* ctx = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(ctx, st->codecpar);
  avcodec_open2(ctx, dec, nullptr);

  SwrContext* swr = swr_alloc();
#if LIBAVUTIL_VERSION_MAJOR >= 57
  AVChannelLayout mono;
  av_channel_layout_default(&mono, 1);
  AVChannelLayout in_layout = ctx->ch_layout;
  if (in_layout.nb_channels == 0) av_channel_layout_default(&in_layout, 1);
  av_opt_set_chlayout(swr, "in_chlayout", &in_layout, 0);
  av_opt_set_chlayout(swr, "out_chlayout", &mono, 0);
#endif
  av_opt_set_int(swr, "in_sample_rate", ctx->sample_rate, 0);
  av_opt_set_int(swr, "out_sample_rate", target_sr, 0);
  av_opt_set_sample_fmt(swr, "in_sample_fmt", ctx->sample_fmt, 0);
  av_opt_set_sample_fmt(swr, "out_sample_fmt", AV_SAMPLE_FMT_FLT, 0);
  swr_init(swr);

  std::vector<float> out;
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  std::vector<float> tmp;
  auto drain = [&](AVFrame* f) {
    int max_out =
        static_cast<int>(av_rescale_rnd(f ? f->nb_samples + 256 : 4096,
                                        target_sr, ctx->sample_rate, AV_ROUND_UP));
    tmp.resize(max_out);
    uint8_t* outp[1] = {reinterpret_cast<uint8_t*>(tmp.data())};
    int got = swr_convert(swr, outp, max_out,
                          f ? const_cast<const uint8_t**>(f->extended_data) : nullptr,
                          f ? f->nb_samples : 0);
    if (got > 0) out.insert(out.end(), tmp.begin(), tmp.begin() + got);
  };
  while (av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == sidx && avcodec_send_packet(ctx, pkt) == 0) {
      while (avcodec_receive_frame(ctx, frame) == 0) drain(frame);
    }
    av_packet_unref(pkt);
  }
  avcodec_send_packet(ctx, nullptr);
  while (avcodec_receive_frame(ctx, frame) == 0) drain(frame);
  drain(nullptr);  // flush resampler

  av_frame_free(&frame);
  av_packet_free(&pkt);
  swr_free(&swr);
  avcodec_free_context(&ctx);
  avformat_close_input(&fmt);
  av_freep(&avio->buffer);
  avio_context_free(&avio);

  auto* res = static_cast<float*>(malloc(out.size() * sizeof(float)));
  memcpy(res, out.data(), out.size() * sizeof(float));
  *out_len = static_cast<int>(out.size());
  return res;
}

void ltav_free(float* p) { free(p); }

const char* ltav_video_encoder_name() {
  for (const char* name : {"libx264", "libopenh264", "h264", "mpeg4", "flv"}) {
    if (avcodec_find_encoder_by_name(name)) return name;
  }
  return "none";
}

}  // extern "C"
