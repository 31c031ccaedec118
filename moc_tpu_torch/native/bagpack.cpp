// Native bag-packing runtime: pad + stack + cast patch-embedding bags.
//
// The hot host-side path of the data layer: N variable-length float bags
// must become one contiguous [B, n_pad, D] float32 block plus a [B, n_pad]
// mask before device transfer. The reference delegates this to torch
// DataLoader workers (one process per worker, pickled tensors); here it is
// a multithreaded memcpy kernel exposed over a C ABI (ctypes — no pybind11
// in this toolchain) with f32 and f16→f32 entry points.
//
// Build: see moc_tpu/data/native.py (g++ -O3 -shared -fPIC -pthread).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// IEEE 754 half → float (scalar; autovectorizes under -O3)
inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      int shift = 0;
      while (!(mant & 0x400)) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3ff;
      // subnormal: value = m · 2⁻²⁴; after `shift` normalizing shifts the
      // unbiased exponent is −14 − shift ⇒ biased 113 − shift
      bits = sign | ((113 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

template <typename Fn>
void parallel_for(int n, int n_threads, Fn fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  int per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int lo = t * per;
    int hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    pool.emplace_back([lo, hi, &fn] {
      for (int i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// bags: array of n_bags pointers to [lengths[i], dim] float32 rows.
// out_features: [n_bags, n_pad, dim] float32 (pad rows zeroed).
// out_mask:     [n_bags, n_pad] uint8 (1 = real patch).
void pack_bags_f32(const float** bags, const int64_t* lengths, int64_t n_bags,
                   int64_t dim, int64_t n_pad, float* out_features,
                   uint8_t* out_mask, int n_threads) {
  parallel_for((int)n_bags, n_threads, [&](int i) {
    const float* src = bags[i];
    int64_t n = lengths[i] < n_pad ? lengths[i] : n_pad;
    float* dst = out_features + (size_t)i * n_pad * dim;
    uint8_t* msk = out_mask + (size_t)i * n_pad;
    std::memcpy(dst, src, (size_t)n * dim * sizeof(float));
    std::memset(dst + (size_t)n * dim, 0,
                (size_t)(n_pad - n) * dim * sizeof(float));
    std::memset(msk, 1, (size_t)n);
    std::memset(msk + n, 0, (size_t)(n_pad - n));
  });
}

// Sweep-stack gather: copy each source chunk's kept-prefix rows into a
// shared destination buffer at a precomputed flat row offset, zero-filling
// the n_pad-cn column tail per row. One thread task per (chunk) — the
// python stacker loop held the GIL for every memcpy; this runs them all
// concurrently. dst is [total_rows, n_pad, dim] row-major.
void gather_pack_f32(const float** srcs, const int64_t* rows,
                     const int64_t* ncols, const int64_t* dst_row_off,
                     int64_t n_srcs, int64_t n_pad, int64_t dim, float* dst,
                     int n_threads) {
  parallel_for((int)n_srcs, n_threads, [&](int i) {
    const float* src = srcs[i];
    int64_t b = rows[i], cn = ncols[i];
    float* out = dst + (size_t)dst_row_off[i] * n_pad * dim;
    if (cn == n_pad) {  // contiguous block, single memcpy
      std::memcpy(out, src, (size_t)b * n_pad * dim * sizeof(float));
      return;
    }
    for (int64_t r = 0; r < b; ++r) {
      float* row_out = out + (size_t)r * n_pad * dim;
      std::memcpy(row_out, src + (size_t)r * cn * dim,
                  (size_t)cn * dim * sizeof(float));
      std::memset(row_out + (size_t)cn * dim, 0,
                  (size_t)(n_pad - cn) * dim * sizeof(float));
    }
  });
}

// Per-row symmetric int8 quantization (the --storage_dtype int8 serving
// tier's host step): scales[r] = absmax(x[r])/127, q = clip(rint(x/scale)).
// Fused absmax+quantize per row — each row stays in cache between the two
// passes, where the numpy formulation streams the whole tensor ~4 times
// through temporaries. rint matches numpy's half-to-even (nearbyintf under
// the default FE_TONEAREST mode). All-zero rows get scale 0 / q 0 so the
// dequantized value is exactly 0 (bag padding).
void quantize_rows_i8(const float* x, int64_t n_rows, int64_t dim, int8_t* q,
                      float* scales, int n_threads) {
  // chunk rows so thread-spawn cost amortizes over many small rows
  int64_t chunk = 64;
  int64_t n_chunks = (n_rows + chunk - 1) / chunk;
  parallel_for((int)n_chunks, n_threads, [&](int c) {
    int64_t lo = (int64_t)c * chunk;
    int64_t hi = lo + chunk < n_rows ? lo + chunk : n_rows;
    for (int64_t r = lo; r < hi; ++r) {
      const float* row = x + (size_t)r * dim;
      float amax = 0.0f;
      for (int64_t j = 0; j < dim; ++j) {
        float a = row[j] < 0 ? -row[j] : row[j];
        if (a > amax) amax = a;
      }
      float scale = amax / 127.0f;
      scales[r] = scale;
      int8_t* out = q + (size_t)r * dim;
      if (scale == 0.0f) {
        std::memset(out, 0, (size_t)dim);
        continue;
      }
      float inv = 1.0f / scale;
      for (int64_t j = 0; j < dim; ++j) {
        float v = nearbyintf(row[j] * inv);
        v = v < -127.0f ? -127.0f : (v > 127.0f ? 127.0f : v);
        out[j] = (int8_t)v;
      }
    }
  });
}

// Same, but sources are float16 rows (the on-disk format of several
// feature releases); converts while packing — one pass over the data.
void pack_bags_f16(const uint16_t** bags, const int64_t* lengths,
                   int64_t n_bags, int64_t dim, int64_t n_pad,
                   float* out_features, uint8_t* out_mask, int n_threads) {
  parallel_for((int)n_bags, n_threads, [&](int i) {
    const uint16_t* src = bags[i];
    int64_t n = lengths[i] < n_pad ? lengths[i] : n_pad;
    float* dst = out_features + (size_t)i * n_pad * dim;
    uint8_t* msk = out_mask + (size_t)i * n_pad;
    for (int64_t j = 0; j < n * dim; ++j) dst[j] = half_to_float(src[j]);
    std::memset(dst + (size_t)n * dim, 0,
                (size_t)(n_pad - n) * dim * sizeof(float));
    std::memset(msk, 1, (size_t)n);
    std::memset(msk + n, 0, (size_t)(n_pad - n));
  });
}

}  // extern "C"
