// audio_native: the port's host-side audio runtime: WAV decode, polyphase
// resampling, and the DTW path and median filter of Whisper word
// timestamps.
//
// A copy of the JAX package's native/audio_native.cpp (without its energy
// VAD, which the port computes in numpy), kept so that the port builds
// and loads its own library (audio_rag_tpu_torch/native.py: g++ at first
// use into build/native/). The arithmetic is unchanged, so both packages
// decode, resample and align to the same numbers: f64 Kaiser-sinc taps
// (beta 8.6, 32 taps a phase, floor(n_in * L / M) outputs), the f64 DTW
// with its tie order, the exact median of an odd window.
//
// C ABI only (ctypes). Decode and resample outputs are malloc'd float32
// buffers released with arag_free.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- errors
enum AragStatus {
  ARAG_OK = 0,
  ARAG_BAD_HEADER = 1,
  ARAG_UNSUPPORTED = 2,
  ARAG_TRUNCATED = 3,
  ARAG_BAD_ARGS = 4,
};

void arag_free(void* p) { free(p); }

// ------------------------------------------------------------- WAV decode
static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Decode a RIFF/WAVE buffer to mono float32 in [-1, 1].
// Supports PCM 8/16/24/32-bit and IEEE float32, any channel count
// (averaged). Returns AragStatus.
int arag_wav_decode(const uint8_t* data, size_t len, float** out,
                    int64_t* n_samples, int32_t* sample_rate) {
  if (!data || !out || !n_samples || !sample_rate) return ARAG_BAD_ARGS;
  if (len < 44 || memcmp(data, "RIFF", 4) != 0 ||
      memcmp(data + 8, "WAVE", 4) != 0)
    return ARAG_BAD_HEADER;

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* pcm = nullptr;
  size_t pcm_len = 0;

  size_t pos = 12;
  while (pos + 8 <= len) {
    const uint8_t* hdr = data + pos;
    uint32_t chunk_len = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + chunk_len > len) chunk_len = (uint32_t)(len - pos - 8);
    if (memcmp(hdr, "fmt ", 4) == 0 && chunk_len >= 16) {
      fmt = rd_u16(body);
      channels = rd_u16(body + 2);
      rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
    } else if (memcmp(hdr, "data", 4) == 0) {
      pcm = body;
      pcm_len = chunk_len;
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are word-aligned
  }
  if (!pcm || channels == 0 || rate == 0) return ARAG_BAD_HEADER;
  if (fmt != 1 && fmt != 3) return ARAG_UNSUPPORTED;  // PCM or float
  if (fmt == 3 && bits != 32) return ARAG_UNSUPPORTED;

  const int bytes = bits / 8;
  if (bytes == 0) return ARAG_UNSUPPORTED;
  const int64_t frames = (int64_t)(pcm_len / (bytes * channels));
  float* buf = (float*)malloc(sizeof(float) * (size_t)frames);
  if (!buf) return ARAG_TRUNCATED;

  const float inv_ch = 1.0f / (float)channels;
  for (int64_t i = 0; i < frames; ++i) {
    float acc = 0.0f;
    const uint8_t* f = pcm + (size_t)i * bytes * channels;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* s = f + c * bytes;
      float v = 0.0f;
      switch (bits) {
        case 8:
          v = ((float)s[0] - 128.0f) / 128.0f;
          break;
        case 16: {
          int16_t x = (int16_t)((uint16_t)s[0] | ((uint16_t)s[1] << 8));
          v = (float)x / 32768.0f;
          break;
        }
        case 24: {
          int32_t x = (int32_t)((uint32_t)s[0] | ((uint32_t)s[1] << 8) |
                                ((uint32_t)s[2] << 16));
          if (x & 0x800000) x -= 0x1000000;
          v = (float)x / 8388608.0f;
          break;
        }
        case 32:
          if (fmt == 3) {
            float fx;
            memcpy(&fx, s, 4);
            v = fx;
          } else {
            int32_t x;
            memcpy(&x, s, 4);
            v = (float)x / 2147483648.0f;
          }
          break;
        default:
          free(buf);
          return ARAG_UNSUPPORTED;
      }
      acc += v;
    }
    buf[i] = acc * inv_ch;
  }
  *out = buf;
  *n_samples = frames;
  *sample_rate = (int32_t)rate;
  return ARAG_OK;
}

// -------------------------------------------------- polyphase resampling
static int64_t gcd64(int64_t a, int64_t b) {
  while (b) {
    int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Kaiser-windowed sinc low-pass, polyphase L/M resampler.
// taps_per_phase controls quality (32 ≈ scipy resample_poly defaults).
int arag_resample(const float* in, int64_t n_in, int32_t sr_in,
                  int32_t sr_out, float** out, int64_t* n_out) {
  if (!in || !out || !n_out || sr_in <= 0 || sr_out <= 0)
    return ARAG_BAD_ARGS;
  if (sr_in == sr_out) {
    float* buf = (float*)malloc(sizeof(float) * (size_t)n_in);
    memcpy(buf, in, sizeof(float) * (size_t)n_in);
    *out = buf;
    *n_out = n_in;
    return ARAG_OK;
  }
  const int64_t g = gcd64(sr_in, sr_out);
  const int64_t L = sr_out / g, M = sr_in / g;

  const int taps_per_phase = 32;
  const int64_t half = (int64_t)taps_per_phase * L / 2;
  const double cutoff = 0.5 / (double)(L > M ? L : M);  // in input-rate units/L
  const double beta = 8.6;  // Kaiser, ~90 dB stopband

  // i0(x): modified Bessel, series expansion
  auto bessel_i0 = [](double x) {
    double sum = 1.0, term = 1.0;
    for (int k = 1; k < 32; ++k) {
      term *= (x / (2.0 * k)) * (x / (2.0 * k));
      sum += term;
      if (term < 1e-12 * sum) break;
    }
    return sum;
  };
  const double i0b = bessel_i0(beta);

  const int64_t n_taps = 2 * half + 1;
  double* h = (double*)malloc(sizeof(double) * (size_t)n_taps);
  if (!h) return ARAG_TRUNCATED;
  for (int64_t i = 0; i < n_taps; ++i) {
    const double t = (double)(i - half);  // in upsampled-rate samples
    const double x = 2.0 * cutoff * t;    // sinc argument: 2·fc·t
    double sinc = (t == 0.0) ? 1.0 : sin(M_PI * x) / (M_PI * x);
    const double w = t / (double)half;
    const double kais =
        (fabs(w) <= 1.0) ? bessel_i0(beta * sqrt(1.0 - w * w)) / i0b : 0.0;
    // ideal low-pass 2fc·sinc, interpolation gain L
    h[i] = 2.0 * cutoff * (double)L * sinc * kais;
  }

  const int64_t n_o = (n_in * L) / M;
  float* buf = (float*)malloc(sizeof(float) * (size_t)(n_o > 0 ? n_o : 1));
  if (!buf) {
    free(h);
    return ARAG_TRUNCATED;
  }
  for (int64_t k = 0; k < n_o; ++k) {
    // output sample k corresponds to upsampled index k*M
    const int64_t up = k * M;
    double acc = 0.0;
    // sum over input samples n where up - n*L falls inside the filter
    const int64_t n_lo = (up - half + L - 1) / L - 1;
    const int64_t n_hi = (up + half) / L + 1;
    for (int64_t n = n_lo; n <= n_hi; ++n) {
      if (n < 0 || n >= n_in) continue;
      const int64_t tap = up - n * L + half;
      if (tap < 0 || tap >= n_taps) continue;
      acc += (double)in[n] * h[tap];
    }
    buf[k] = (float)acc;
  }
  free(h);
  *out = buf;
  *n_out = n_o;
  return ARAG_OK;
}

// ---------------------------------------------- word-timestamp alignment
// DTW minimal-cost path over a (N tokens, M frames) cost matrix with steps
// (diag, token-advance, frame-advance) — the hot host loop of Whisper
// word timestamps (asr/word_timing.py dtw_path; reference behavior is
// faster-whisper's, which wraps the same algorithm in C++ too). The
// vectorized-numpy form still costs ~60 ms per 30 s window at
// (260, 1500); this plain DP is <2 ms. Tie-breaking matches the numpy
// implementation exactly: diagonal beats token-advance beats
// frame-advance on equal cost (strict < to replace).
//
// out_ti/out_fi are caller-allocated with capacity >= N + M; returns the
// path length (cells visited, backtracked then reversed), or -1 on bad
// args / alloc failure.
int64_t arag_dtw_path(const float* cost, int64_t N, int64_t M,
                      int32_t* out_ti, int32_t* out_fi) {
  if (!cost || !out_ti || !out_fi || N <= 0 || M <= 0) return -1;
  const double INF = 1e30;
  double* prev = (double*)malloc(sizeof(double) * (M + 1));
  double* cur = (double*)malloc(sizeof(double) * (M + 1));
  int8_t* trace = (int8_t*)malloc((size_t)(N + 1) * (M + 1));
  if (!prev || !cur || !trace) {
    free(prev); free(cur); free(trace);
    return -1;
  }
  prev[0] = 0.0;
  for (int64_t j = 1; j <= M; ++j) prev[j] = INF;
  for (int64_t i = 1; i <= N; ++i) {
    cur[0] = INF;
    const float* row = cost + (i - 1) * M;
    int8_t* trow = trace + i * (M + 1);
    for (int64_t j = 1; j <= M; ++j) {
      double best = prev[j - 1];  // diag
      int8_t t = 0;
      if (prev[j] < best) { best = prev[j]; t = 1; }     // token advance
      if (cur[j - 1] < best) { best = cur[j - 1]; t = 2; }  // frame advance
      cur[j] = best + (double)row[j - 1];
      trow[j] = t;
    }
    double* tmp = prev; prev = cur; cur = tmp;
  }
  // backtrack from (N, M)
  int64_t i = N, j = M, k = 0;
  while (i > 0 && j > 0) {
    out_ti[k] = (int32_t)(i - 1);
    out_fi[k] = (int32_t)(j - 1);
    ++k;
    const int8_t t = trace[i * (M + 1) + j];
    if (t == 0) { --i; --j; }
    else if (t == 1) { --i; }
    else { --j; }
  }
  free(prev); free(cur); free(trace);
  // reverse in place to ascending order (numpy version returns reversed)
  for (int64_t a = 0, b = k - 1; a < b; ++a, --b) {
    int32_t tmp = out_ti[a]; out_ti[a] = out_ti[b]; out_ti[b] = tmp;
    tmp = out_fi[a]; out_fi[a] = out_fi[b]; out_fi[b] = tmp;
  }
  return k;
}

// Width-w median filter along the last axis of a row-major (N, M) f32
// matrix, edge-padded — Whisper's attention smoothing
// (asr/word_timing.py _median_filter; ~50 ms per window in numpy via
// sliding_window_view + np.median, ~1 ms here). Exact match with
// np.median for odd w: the median of w values is the middle of the
// sorted window (an element, no averaging).
int arag_median_filter(const float* x, int64_t N, int64_t M, int32_t w,
                       float* out) {
  if (!x || !out || N <= 0 || M <= 0 || w <= 0 || w > 63 || (w % 2) == 0)
    return ARAG_BAD_ARGS;
  if (w == 1 || M < w) {
    memcpy(out, x, sizeof(float) * (size_t)N * M);
    return ARAG_OK;
  }
  const int32_t half = w / 2;
  float buf[63];
  for (int64_t i = 0; i < N; ++i) {
    const float* row = x + i * M;
    float* orow = out + i * M;
    for (int64_t j = 0; j < M; ++j) {
      for (int32_t t = -half; t <= half; ++t) {
        int64_t jj = j + t;
        if (jj < 0) jj = 0;
        if (jj >= M) jj = M - 1;
        // insertion sort into buf
        float v = row[jj];
        int32_t p = t + half;
        while (p > 0 && buf[p - 1] > v) { buf[p] = buf[p - 1]; --p; }
        buf[p] = v;
      }
      orow[j] = buf[half];
    }
  }
  return ARAG_OK;
}

}  // extern "C"
