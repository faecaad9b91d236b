// Native audio runtime: PCM conversion, resampling, SPSC ring buffer.
//
// Host-side equivalent of the compute the reference delegates to ffmpeg's
// format layer + numpy (reference audio_processor.py convert_pcm_to_float,
// whisper/audio.py load_audio resampling). These run per-chunk on every
// live session, so they are the server's per-packet hot path; -O3
// auto-vectorizes the conversion loops. Exposed via ctypes (no pybind11 in
// the image); whisperlivekit_tpu.native falls back to numpy when no
// compiler is available.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <atomic>
#include <algorithm>

extern "C" {

// ---- conversions -----------------------------------------------------------

void s16le_to_f32(const int16_t* in, float* out, int64_t n) {
    constexpr float k = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] * k;
}

void f32_to_s16le(const float* in, int16_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i] * 32768.0f;
        v = std::max(-32768.0f, std::min(32767.0f, v));
        out[i] = (int16_t)lrintf(v);
    }
}

// stereo/multichannel s16 interleaved -> mono f32 (mean of channels)
void s16le_to_f32_mono(const int16_t* in, float* out, int64_t frames, int channels) {
    const float k = 1.0f / (32768.0f * channels);
    for (int64_t i = 0; i < frames; ++i) {
        int32_t acc = 0;
        for (int c = 0; c < channels; ++c) acc += in[i * channels + c];
        out[i] = acc * k;
    }
}

// ---- linear resampler (stateful across calls for streaming) ----------------

// Returns number of output samples written. `state` carries the fractional
// read position and the last input sample across chunk boundaries.
typedef struct {
    double pos;      // fractional position into the virtual input stream
    float last;      // previous chunk's final sample
    int has_last;
} resample_state;

int64_t resample_linear(
    resample_state* st, const float* in, int64_t n_in,
    double ratio /* out_rate / in_rate */, float* out, int64_t out_cap) {
    // virtual input: [last, in[0..n_in)); positions in units of input samples,
    // with position 0 == `last` when it exists, else in[0].
    int64_t written = 0;
    double step = 1.0 / ratio;
    double pos = st->pos;
    int64_t base = st->has_last ? 1 : 0;  // index offset of in[0]
    int64_t total = n_in + base;
    while (pos + 1.0 < (double)total && written < out_cap) {
        int64_t i0 = (int64_t)pos;
        double frac = pos - (double)i0;
        float a = (i0 < base) ? st->last : in[i0 - base];
        int64_t i1 = i0 + 1;
        float b = (i1 < base) ? st->last : in[i1 - base];
        out[written++] = (float)((1.0 - frac) * a + frac * b);
        pos += step;
    }
    // rebase so in[n_in-1] becomes `last` at index 0
    st->last = n_in > 0 ? in[n_in - 1] : st->last;
    st->has_last = 1;
    st->pos = pos - (double)(total - 1);
    if (st->pos < 0) st->pos = 0;
    return written;
}

// ---- SPSC ring buffer (single producer / single consumer, lock-free) -------

typedef struct {
    float* data;
    int64_t capacity;
    std::atomic<int64_t> head;  // write index (producer)
    std::atomic<int64_t> tail;  // read index (consumer)
} ring_buffer;

ring_buffer* ring_create(int64_t capacity) {
    ring_buffer* rb = (ring_buffer*)std::malloc(sizeof(ring_buffer));
    if (!rb) return nullptr;
    rb->data = (float*)std::malloc(sizeof(float) * capacity);
    if (!rb->data) { std::free(rb); return nullptr; }
    rb->capacity = capacity;
    rb->head.store(0);
    rb->tail.store(0);
    return rb;
}

void ring_destroy(ring_buffer* rb) {
    if (rb) { std::free(rb->data); std::free(rb); }
}

int64_t ring_size(const ring_buffer* rb) {
    return rb->head.load(std::memory_order_acquire) -
           rb->tail.load(std::memory_order_acquire);
}

int64_t ring_push(ring_buffer* rb, const float* in, int64_t n) {
    int64_t head = rb->head.load(std::memory_order_relaxed);
    int64_t tail = rb->tail.load(std::memory_order_acquire);
    int64_t space = rb->capacity - (head - tail);
    n = std::min(n, space);
    for (int64_t i = 0; i < n; ++i)
        rb->data[(head + i) % rb->capacity] = in[i];
    rb->head.store(head + n, std::memory_order_release);
    return n;
}

int64_t ring_pop(ring_buffer* rb, float* out, int64_t n) {
    int64_t tail = rb->tail.load(std::memory_order_relaxed);
    int64_t head = rb->head.load(std::memory_order_acquire);
    int64_t avail = head - tail;
    n = std::min(n, avail);
    for (int64_t i = 0; i < n; ++i)
        out[i] = rb->data[(tail + i) % rb->capacity];
    rb->tail.store(tail + n, std::memory_order_release);
    return n;
}

}  // extern "C"
