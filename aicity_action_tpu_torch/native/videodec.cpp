// FFmpeg video decoder for the sliding-window pipeline (a copy of
// aicity_action_tpu/native/videodec.cpp with one entry point added,
// vdec_meta), shaped for the chunk path in
// aicity_action_tpu_torch/pipeline/window_inference.py:
//
//   decode -> ROI crop -> resize -> planar I420 rows, one frame at a time,
//   written straight into the caller's chunk slab.
//
// Why not cv2: cv2.VideoCapture converts every frame yuv420p -> BGR, the
// pipeline then resizes 3 B/px interleaved BGR and re-encodes I420.
// Decoding to the encoder's own YUV planes and sws_scaling them at 1.5 B/px
// skips both conversions and halves the resize work. The sws flags and the
// crop's even alignment are the JAX package's, so both decoders give the
// same I420 bytes.
//
// C ABI only (loaded through ctypes, which releases the GIL in each call).
// Built at first use by aicity_action_tpu_torch/native/__init__.py.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

namespace {

struct VDec {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* dec = nullptr;
    SwsContext* sws = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    int stream_idx = -1;
    int out_w = 0, out_h = 0;
    // ROI crop in source pixels (x1, y1 rounded down to even for chroma
    // alignment; x2 - x1 / y2 - y1 rounded down to even)
    int cx = 0, cy = 0, cw = 0, ch = 0;
    bool draining = false;
    bool pending = false;  // d->frame already holds the next frame (seek)
    int64_t next_frame = 0;  // index of the next frame vdec_read returns
    AVRational frame_dur{0, 1};  // one frame in stream time_base units
};

// Decode the next frame into d->frame. Returns 1 on success, 0 on EOF,
// <0 on error.
int next_frame(VDec* d) {
    if (d->pending) {
        d->pending = false;
        return 1;
    }
    for (;;) {
        int r = avcodec_receive_frame(d->dec, d->frame);
        if (r == 0) return 1;
        if (r == AVERROR_EOF) return 0;
        if (r != AVERROR(EAGAIN)) return r;
        if (d->draining) return 0;
        for (;;) {
            r = av_read_frame(d->fmt, d->pkt);
            if (r == AVERROR_EOF) {
                d->draining = true;
                avcodec_send_packet(d->dec, nullptr);
                break;
            }
            if (r < 0) return r;
            if (d->pkt->stream_index == d->stream_idx) {
                r = avcodec_send_packet(d->dec, d->pkt);
                av_packet_unref(d->pkt);
                if (r < 0 && r != AVERROR(EAGAIN)) return r;
                break;
            }
            av_packet_unref(d->pkt);
        }
    }
}

}  // namespace

extern "C" {

// Stream metadata without decoding a frame, as OpenCV's FFmpeg capture
// reports it: `frames` is the container's nb_frames where it records one
// (mp4), else round(duration_s * fps) (CAP_PROP_FRAME_COUNT; y4m records
// none); `fps` is avg_frame_rate, else 1 / time_base (CAP_PROP_FPS).
// `yuv420p` is 1 where the stream's pixel format is the plain yuv420p that
// vdec_open takes. Returns 0, or <0 where FFmpeg cannot open the file or
// it holds no video stream.
int vdec_meta(const char* path, int64_t* frames, double* fps, int* width,
              int* height, int* yuv420p) {
    AVFormatContext* fmt = nullptr;
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
    int rc = -1;
    do {
        if (avformat_find_stream_info(fmt, nullptr) < 0) break;
        int idx = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                      nullptr, 0);
        if (idx < 0) break;
        const AVStream* st = fmt->streams[idx];
        double rate = av_q2d(st->avg_frame_rate);
        if (rate < 1e-6 && st->time_base.num > 0)
            rate = 1.0 / av_q2d(st->time_base);
        double sec = (double)fmt->duration / AV_TIME_BASE;
        if (sec < 1e-6) sec = (double)st->duration * av_q2d(st->time_base);
        int64_t n = st->nb_frames;
        if (n == 0) n = (int64_t)std::floor(sec * rate + 0.5);
        *frames = n < 0 ? 0 : n;
        *fps = rate;
        *width = st->codecpar->width;
        *height = st->codecpar->height;
        *yuv420p = st->codecpar->format == AV_PIX_FMT_YUV420P;
        rc = 0;
    } while (false);
    avformat_close_input(&fmt);
    return rc;
}

// Open `path` for sequential I420 reads of out_w x out_h frames cropped to
// [x1, x2) x [y1, y2) source pixels (pass 0,0,0,0 for full frame).
// Returns nullptr if the container/codec/pixel format is unsupported.
void* vdec_open(const char* path, int out_w, int out_h,
                int x1, int y1, int x2, int y2) {
    if (out_w % 2 || out_h % 2) return nullptr;
    VDec* d = new VDec();
    do {
        if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) break;
        if (avformat_find_stream_info(d->fmt, nullptr) < 0) break;
        const AVCodec* codec = nullptr;
        d->stream_idx = av_find_best_stream(
            d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
        if (d->stream_idx < 0 || !codec) break;
        AVStream* st = d->fmt->streams[d->stream_idx];
        d->dec = avcodec_alloc_context3(codec);
        if (!d->dec) break;
        if (avcodec_parameters_to_context(d->dec, st->codecpar) < 0) break;
        d->dec->thread_count = 0;  // auto: scales on multi-core hosts
        if (avcodec_open2(d->dec, codec, nullptr) < 0) break;
        // the device-side inverse (i420_to_rgb) assumes limited-range
        // BT.601; only pass through the plain yuv420p everyone encodes
        if (d->dec->pix_fmt != AV_PIX_FMT_YUV420P) break;
        int W = d->dec->width, H = d->dec->height;
        if (W <= 0 || H <= 0) break;
        if (x2 <= x1 || y2 <= y1) { x1 = 0; y1 = 0; x2 = W; y2 = H; }
        if (x1 < 0 || y1 < 0 || x2 > W || y2 > H) break;
        d->cx = x1 & ~1;
        d->cy = y1 & ~1;
        d->cw = (x2 - d->cx) & ~1;
        d->ch = (y2 - d->cy) & ~1;
        if (d->cw < 2 || d->ch < 2) break;
        d->out_w = out_w;
        d->out_h = out_h;
        d->sws = sws_getContext(d->cw, d->ch, AV_PIX_FMT_YUV420P,
                                out_w, out_h, AV_PIX_FMT_YUV420P,
                                SWS_BILINEAR, nullptr, nullptr, nullptr);
        if (!d->sws) break;
        d->pkt = av_packet_alloc();
        d->frame = av_frame_alloc();
        if (!d->pkt || !d->frame) break;
        AVRational fr = st->avg_frame_rate;
        if (fr.num <= 0 || fr.den <= 0) fr = av_guess_frame_rate(
            d->fmt, st, nullptr);
        if (fr.num > 0 && fr.den > 0)
            d->frame_dur = av_div_q(
                av_make_q(fr.den, fr.num), st->time_base);
        return d;
    } while (false);
    if (d->sws) sws_freeContext(d->sws);
    if (d->dec) avcodec_free_context(&d->dec);
    if (d->fmt) avformat_close_input(&d->fmt);
    if (d->pkt) av_packet_free(&d->pkt);
    if (d->frame) av_frame_free(&d->frame);
    delete d;
    return nullptr;
}

// Decode the next frame, crop+scale it, and write planar I420 into `out`
// (out_h*3/2 rows of out_w bytes: Y, then U, then V). Returns 1 on
// success, 0 on EOF, <0 on decode error.
int vdec_read_i420(void* handle, uint8_t* out) {
    VDec* d = static_cast<VDec*>(handle);
    int r = next_frame(d);
    if (r <= 0) return r;
    const int w = d->out_w, h = d->out_h;
    const uint8_t* src[3] = {
        d->frame->data[0] + d->cy * d->frame->linesize[0] + d->cx,
        d->frame->data[1] + (d->cy / 2) * d->frame->linesize[1] + d->cx / 2,
        d->frame->data[2] + (d->cy / 2) * d->frame->linesize[2] + d->cx / 2,
    };
    uint8_t* dst[3] = {out, out + w * h, out + w * h + (w / 2) * (h / 2)};
    int dst_stride[3] = {w, w / 2, w / 2};
    sws_scale(d->sws, src, d->frame->linesize, 0, d->ch, dst, dst_stride);
    av_frame_unref(d->frame);
    d->next_frame += 1;
    return 1;
}

// Position the decoder so the next vdec_read_i420 returns frame
// `target` (0-based). Seeks to the preceding keyframe and decodes
// forward — the same CFR frame->timestamp assumption cv2's
// CAP_PROP_POS_FRAMES makes. Returns 0 on success (including landing at
// EOF before `target`, where the next read returns 0), <0 on error.
int vdec_seek(void* handle, int64_t target) {
    VDec* d = static_cast<VDec*>(handle);
    if (target == d->next_frame) return 0;
    if (d->frame_dur.num <= 0) return -1;  // no usable frame rate: refuse
    if (d->pending) {
        av_frame_unref(d->frame);
        d->pending = false;
    }
    AVStream* st = d->fmt->streams[d->stream_idx];
    int64_t start = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
    int64_t target_pts =
        start + av_rescale(target, d->frame_dur.num, d->frame_dur.den);
    if (av_seek_frame(d->fmt, d->stream_idx, target_pts,
                      AVSEEK_FLAG_BACKWARD) < 0)
        return -1;
    avcodec_flush_buffers(d->dec);
    d->draining = false;
    // decode forward until the frame AT OR PAST target lands next;
    // half-frame tolerance absorbs timestamp rounding. TRUNCATED, not
    // av_rescale's round-to-nearest: with frame_dur == 1 tick (time_base
    // == 1/fps) a rounded half of 1 would accept frame target-1 and
    // silently shift every seek one frame early.
    int64_t half = d->frame_dur.num / (2 * d->frame_dur.den);
    for (;;) {
        int r = next_frame(d);
        if (r < 0) return r;
        if (r == 0) {  // EOF before target: next read reports EOF
            d->next_frame = target;
            return 0;
        }
        int64_t pts = d->frame->best_effort_timestamp;
        if (pts == AV_NOPTS_VALUE) pts = d->frame->pts;
        if (pts == AV_NOPTS_VALUE || pts + half >= target_pts) {
            // this frame IS `target`: hold it — the next read consumes it
            d->next_frame = target;
            d->pending = true;
            return 0;
        }
        av_frame_unref(d->frame);
    }
}

// Decode and discard `n` frames WITHOUT crop/scale work — the cheap
// analog of cv2's grab() for containers that refuse timestamp seeks.
// Returns the number of frames actually skipped (< n means EOF).
int64_t vdec_skip(void* handle, int64_t n) {
    VDec* d = static_cast<VDec*>(handle);
    int64_t done = 0;
    while (done < n) {
        int r = next_frame(d);
        if (r <= 0) break;
        av_frame_unref(d->frame);
        d->next_frame += 1;
        done += 1;
    }
    return done;
}

void vdec_close(void* handle) {
    VDec* d = static_cast<VDec*>(handle);
    if (d->sws) sws_freeContext(d->sws);
    if (d->dec) avcodec_free_context(&d->dec);
    if (d->fmt) avformat_close_input(&d->fmt);
    if (d->pkt) av_packet_free(&d->pkt);
    if (d->frame) av_frame_free(&d->frame);
    delete d;
}

}  // extern "C"
