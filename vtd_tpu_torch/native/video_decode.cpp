// Native video decode: demux -> decode -> swscale, host C++ of the port
// with a C API (vtd_tpu_torch/native/video.py builds it with g++ and binds
// it with ctypes). The same decoder as vtd_tpu/native/video_decode.cpp:
// built against the same libav with the same flags, it writes the same
// bytes.
//
// It feeds the pipeline's batched frame stream in place of cv2's
// VideoCapture (vtd_tpu_torch/video/processor.py, stride sampling at a
// target fps). The cv2 path pays, per sampled frame, a yuv->BGR
// full-resolution convert, a BGR resize and a BGR->yuv420 convert on the
// host that also feeds the card. This decoder stays in the codec's own
// yuv420p: sampled frames are swscaled (planar, 1.5 B/px) straight to the
// ship size, and skipped frames never leave the decoder. Decode uses
// FFmpeg's threaded slice/frame decoder (thread_count=0 == auto).
//
// Output pixel formats: I420 planar (packed [H*3/2, W], the layout of
// cv2.COLOR_BGR2YUV_I420 that ops/preprocess.py's yuv420_to_bgr reads)
// or BGR24 interleaved.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstring>

namespace {

// Scene-change signature dims (the cv2 gate's 64x36 INTER_AREA
// thumbnail, video/processor.py::_keyframe_signature).
constexpr int kSigW = 64;
constexpr int kSigH = 36;

struct Decoder {
  AVFormatContext *fmt = nullptr;
  AVCodecContext *codec = nullptr;
  SwsContext *sws = nullptr;
  AVPacket *pkt = nullptr;
  AVFrame *frame = nullptr;
  int stream_index = -1;
  int64_t next_src = 0;  // source index of the next frame decode will emit
  int sws_w = 0, sws_h = 0, sws_fmt = -1;
  int src_w = 0, src_h = 0;
  AVPixelFormat src_pix = AV_PIX_FMT_NONE;
  bool draining = false;
  bool eof = false;
  // Keyframe-gate state (persists across read_batch calls so batch
  // boundaries never reset scene-change detection).
  SwsContext *sig_sws = nullptr;
  int sig_src_w = 0, sig_src_h = 0, sig_src_fmt = -1;
  uint8_t sig_last[kSigW * kSigH];
  bool sig_valid = false;
  int64_t last_kf = -1;
  int since_kf = 0;
};

void free_decoder(Decoder *d) {
  if (!d) return;
  if (d->sig_sws) sws_freeContext(d->sig_sws);
  if (d->sws) sws_freeContext(d->sws);
  if (d->frame) av_frame_free(&d->frame);
  if (d->pkt) av_packet_free(&d->pkt);
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

// Pull the next decoded frame into d->frame. Returns 1 on frame, 0 on EOF,
// <0 on error.
int next_frame(Decoder *d) {
  while (true) {
    int ret = avcodec_receive_frame(d->codec, d->frame);
    if (ret == 0) return 1;
    if (ret == AVERROR_EOF) {
      d->eof = true;
      return 0;
    }
    if (ret != AVERROR(EAGAIN)) return ret;
    if (d->draining) {
      // EAGAIN after sending the flush packet should not happen; treat
      // as EOF defensively.
      d->eof = true;
      return 0;
    }
    // Need more input.
    while (true) {
      ret = av_read_frame(d->fmt, d->pkt);
      if (ret == AVERROR_EOF) {
        d->draining = true;
        avcodec_send_packet(d->codec, nullptr);
        break;
      }
      if (ret < 0) return ret;
      if (d->pkt->stream_index == d->stream_index) {
        ret = avcodec_send_packet(d->codec, d->pkt);
        av_packet_unref(d->pkt);
        if (ret < 0 && ret != AVERROR(EAGAIN)) return ret;
        break;
      }
      av_packet_unref(d->pkt);
    }
  }
}

}  // namespace

extern "C" {

void *vtd_vd_open(const char *path) {
  Decoder *d = new Decoder();
  if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) {
    free_decoder(d);
    return nullptr;
  }
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
    free_decoder(d);
    return nullptr;
  }
  const AVCodec *dec = nullptr;
  d->stream_index =
      av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
  if (d->stream_index < 0 || !dec) {
    free_decoder(d);
    return nullptr;
  }
  AVStream *st = d->fmt->streams[d->stream_index];
  d->codec = avcodec_alloc_context3(dec);
  if (!d->codec ||
      avcodec_parameters_to_context(d->codec, st->codecpar) < 0) {
    free_decoder(d);
    return nullptr;
  }
  d->codec->thread_count = 0;  // auto: frame/slice threading on multicore
  if (avcodec_open2(d->codec, dec, nullptr) < 0) {
    free_decoder(d);
    return nullptr;
  }
  d->pkt = av_packet_alloc();
  d->frame = av_frame_alloc();
  d->src_w = d->codec->width;
  d->src_h = d->codec->height;
  return d;
}

// fps (rational -> double), frame count (0 when unknown), dims.
int vtd_vd_info(void *h, double *fps, int64_t *frame_count, int *width,
                int *height) {
  Decoder *d = (Decoder *)h;
  AVStream *st = d->fmt->streams[d->stream_index];
  AVRational r = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
  *fps = r.den ? (double)r.num / r.den : 0.0;
  int64_t n = st->nb_frames;
  if (n <= 0 && *fps > 0 && d->fmt->duration > 0)
    n = (int64_t)(d->fmt->duration * (*fps) / AV_TIME_BASE + 0.5);
  *frame_count = n > 0 ? n : 0;
  *width = d->src_w;
  *height = d->src_h;
  return 0;
}

// Seek so the next emitted frame is source index `target`. Uses a
// keyframe seek then decode-skips forward; exact (frame-accurate) by
// construction because we count emitted frames from the keyframe.
int vtd_vd_seek(void *h, int64_t target) {
  Decoder *d = (Decoder *)h;
  AVStream *st = d->fmt->streams[d->stream_index];
  AVRational r = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
  if (!r.num || !r.den) return -1;
  // Frame indices are relative to the stream's first pts: containers
  // with edit lists / TS streams start at a nonzero start_time, and
  // ignoring it would mislabel every post-seek frame by
  // start_time*fps (overlapping/skipped parallel-decode segments).
  int64_t start = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
  int64_t ts = start + av_rescale_q(target, av_inv_q(r), st->time_base);
  if (av_seek_frame(d->fmt, d->stream_index, ts, AVSEEK_FLAG_BACKWARD) < 0)
    return -1;
  avcodec_flush_buffers(d->codec);
  d->draining = false;
  d->eof = false;
  // Decode forward until we reach `target`, deriving the index of the
  // first post-seek frame from its pts.
  while (true) {
    int ret = next_frame(d);
    if (ret <= 0) return ret < 0 ? ret : -1;
    int64_t pts = d->frame->best_effort_timestamp;
    int64_t idx = pts == AV_NOPTS_VALUE
                      ? target  // no pts: assume we landed exactly
                      : av_rescale_q(pts - start, st->time_base,
                                     av_inv_q(r));
    if (idx >= target) {
      // d->frame holds frame `idx`, not yet delivered: the caller passes
      // hot=1 to the next read so that it is scaled before decoding on.
      d->next_src = idx;
      return 1;
    }
    d->next_src = idx + 1;
  }
}

// Decode forward, writing every `stride`-th source frame (those with
// src_index % stride == 0), scaled to out_w x out_h, into `out`.
// fmt: 0 = I420 packed [h*3/2, w] per frame, 1 = BGR24 [h, w, 3].
// `hot` nonzero means d->frame already holds an undelivered frame (set
// by vtd_vd_seek). Writes at most max_frames frames; returns the number
// written (0 => EOF), filling src_indices[i] with each frame's source
// index. Stops early at src_end (exclusive) when src_end >= 0.
int vtd_vd_read_batch(void *h, int stride, int max_frames, int64_t src_end,
                      int hot, uint8_t *out, int64_t *src_indices, int out_w,
                      int out_h, int fmt) {
  Decoder *d = (Decoder *)h;
  if (stride < 1) stride = 1;
  const AVPixelFormat want =
      fmt == 1 ? AV_PIX_FMT_BGR24 : AV_PIX_FMT_YUV420P;
  const size_t frame_bytes =
      fmt == 1 ? (size_t)out_w * out_h * 3 : (size_t)out_w * out_h * 3 / 2;
  int written = 0;
  bool use_hot = hot != 0;
  while (written < max_frames) {
    int64_t idx;
    if (use_hot) {
      use_hot = false;
      idx = d->next_src;
    } else {
      int ret = next_frame(d);
      if (ret == 0) break;
      if (ret < 0) return ret;
      idx = d->next_src;
    }
    d->next_src = idx + 1;
    if (src_end >= 0 && idx >= src_end) break;
    if (idx % stride != 0) continue;

    if (!d->sws || d->sws_w != out_w || d->sws_h != out_h ||
        d->sws_fmt != (int)want || d->src_pix != (AVPixelFormat)d->frame->format) {
      if (d->sws) sws_freeContext(d->sws);
      d->src_pix = (AVPixelFormat)d->frame->format;
      d->sws = sws_getContext(d->frame->width, d->frame->height, d->src_pix,
                              out_w, out_h, want, SWS_FAST_BILINEAR, nullptr,
                              nullptr, nullptr);
      if (!d->sws) return -2;
      d->sws_w = out_w;
      d->sws_h = out_h;
      d->sws_fmt = (int)want;
    }
    uint8_t *dst = out + (size_t)written * frame_bytes;
    uint8_t *planes[4] = {nullptr, nullptr, nullptr, nullptr};
    int strides[4] = {0, 0, 0, 0};
    if (fmt == 1) {
      planes[0] = dst;
      strides[0] = out_w * 3;
    } else {
      planes[0] = dst;                                  // Y
      planes[1] = dst + (size_t)out_w * out_h;          // U
      planes[2] = dst + (size_t)out_w * out_h * 5 / 4;  // V
      strides[0] = out_w;
      strides[1] = out_w / 2;
      strides[2] = out_w / 2;
    }
    sws_scale(d->sws, d->frame->data, d->frame->linesize, 0,
              d->frame->height, planes, strides);
    src_indices[written] = idx;
    ++written;
  }
  return written;
}

// Keyframe-gated variant of vtd_vd_read_batch: candidates (every
// stride-th source frame) whose 64x36 luma thumbnail differs from the
// last KEPT frame's by a mean abs diff < kf_diff are classified
// near-duplicates — they never get the full sws_scale or cross into
// Python as pixels; only (index, keyframe index) pairs do. Mirrors the
// cv2 gate in video/processor.py (scene-change detection with a
// forced keyframe every kf_max_gap candidates) but runs on the decoded
// full-res Y plane BEFORE the ship-size scale, so ~90% of candidates
// in static footage cost decode + a 64x36 area scale only.
//
// Gate state (last kept signature, gap counter, last keyframe index)
// lives in the Decoder and persists across calls; vtd_vd_seek resets
// it via kf_reset=1 on the next call when the caller starts a new
// segment. Duplicate records append to dup_indices/dup_refs (capacity
// max_dups); the call returns early when either the frame buffer or
// the dup buffer fills. Returns frames written, with *n_dups set; 0
// frames AND 0 dups => EOF.
int vtd_vd_read_batch_kf(void *h, int stride, int max_frames,
                         int64_t src_end, int hot, uint8_t *out,
                         int64_t *src_indices, int out_w, int out_h, int fmt,
                         double kf_diff, int kf_max_gap, int kf_reset,
                         int64_t *dup_indices, int64_t *dup_refs,
                         int max_dups, int *n_dups) {
  Decoder *d = (Decoder *)h;
  if (stride < 1) stride = 1;
  if (kf_max_gap < 1) kf_max_gap = 1;
  if (kf_reset) {
    d->sig_valid = false;
    d->last_kf = -1;
    d->since_kf = 0;
  }
  const AVPixelFormat want =
      fmt == 1 ? AV_PIX_FMT_BGR24 : AV_PIX_FMT_YUV420P;
  const size_t frame_bytes =
      fmt == 1 ? (size_t)out_w * out_h * 3 : (size_t)out_w * out_h * 3 / 2;
  int written = 0;
  *n_dups = 0;
  bool use_hot = hot != 0;
  uint8_t sig[kSigW * kSigH];
  while (written < max_frames && *n_dups < max_dups) {
    int64_t idx;
    if (use_hot) {
      use_hot = false;
      idx = d->next_src;
    } else {
      int ret = next_frame(d);
      if (ret == 0) break;
      if (ret < 0) return ret;
      idx = d->next_src;
    }
    d->next_src = idx + 1;
    if (src_end >= 0 && idx >= src_end) break;
    if (idx % stride != 0) continue;

    // 64x36 luma signature of the decoded frame (SWS_AREA ~ cv2
    // INTER_AREA). Rebuild the tiny context only when the source
    // geometry changes.
    if (!d->sig_sws || d->sig_src_w != d->frame->width ||
        d->sig_src_h != d->frame->height ||
        d->sig_src_fmt != (int)d->frame->format) {
      if (d->sig_sws) sws_freeContext(d->sig_sws);
      d->sig_sws = sws_getContext(
          d->frame->width, d->frame->height,
          (AVPixelFormat)d->frame->format, kSigW, kSigH, AV_PIX_FMT_GRAY8,
          SWS_AREA, nullptr, nullptr, nullptr);
      if (!d->sig_sws) return -2;
      d->sig_src_w = d->frame->width;
      d->sig_src_h = d->frame->height;
      d->sig_src_fmt = (int)d->frame->format;
    }
    uint8_t *splanes[4] = {sig, nullptr, nullptr, nullptr};
    int sstrides[4] = {kSigW, 0, 0, 0};
    sws_scale(d->sig_sws, d->frame->data, d->frame->linesize, 0,
              d->frame->height, splanes, sstrides);

    if (d->sig_valid && d->since_kf < kf_max_gap) {
      int64_t sad = 0;
      for (int i = 0; i < kSigW * kSigH; ++i)
        sad += sig[i] > d->sig_last[i] ? sig[i] - d->sig_last[i]
                                       : d->sig_last[i] - sig[i];
      if ((double)sad / (kSigW * kSigH) < kf_diff) {
        ++d->since_kf;
        dup_indices[*n_dups] = idx;
        dup_refs[*n_dups] = d->last_kf;
        ++*n_dups;
        continue;
      }
    }
    memcpy(d->sig_last, sig, sizeof(sig));
    d->sig_valid = true;
    d->last_kf = idx;
    d->since_kf = 0;

    if (!d->sws || d->sws_w != out_w || d->sws_h != out_h ||
        d->sws_fmt != (int)want ||
        d->src_pix != (AVPixelFormat)d->frame->format) {
      if (d->sws) sws_freeContext(d->sws);
      d->src_pix = (AVPixelFormat)d->frame->format;
      d->sws = sws_getContext(d->frame->width, d->frame->height, d->src_pix,
                              out_w, out_h, want, SWS_FAST_BILINEAR, nullptr,
                              nullptr, nullptr);
      if (!d->sws) return -2;
      d->sws_w = out_w;
      d->sws_h = out_h;
      d->sws_fmt = (int)want;
    }
    uint8_t *dst = out + (size_t)written * frame_bytes;
    uint8_t *planes[4] = {nullptr, nullptr, nullptr, nullptr};
    int strides[4] = {0, 0, 0, 0};
    if (fmt == 1) {
      planes[0] = dst;
      strides[0] = out_w * 3;
    } else {
      planes[0] = dst;                                  // Y
      planes[1] = dst + (size_t)out_w * out_h;          // U
      planes[2] = dst + (size_t)out_w * out_h * 5 / 4;  // V
      strides[0] = out_w;
      strides[1] = out_w / 2;
      strides[2] = out_w / 2;
    }
    sws_scale(d->sws, d->frame->data, d->frame->linesize, 0,
              d->frame->height, planes, strides);
    src_indices[written] = idx;
    ++written;
  }
  return written;
}

void vtd_vd_close(void *h) { free_decoder((Decoder *)h); }

}  // extern "C"
