// Native host-side ingestion helpers for quantization_tpu.
//
// The reference implements its hot scoring loops in native code
// (quantization/cpp/{sse,avx2,neon}.c); here scoring runs on the device
// (quantization_tpu/ops/). What remains host-side — streaming ingestion:
// affine u8 quantization with per-vector correction terms, sign
// bit-packing, and calibration scans — is implemented here so corpora larger
// than device memory can be encoded at memory bandwidth without burning
// device cycles.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
// Build: g++ -O3 -march=native -shared -fPIC (see loader.py).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// distance_type: 0 = Dot, 1 = L1, 2 = L2 (matches DistanceType order).
//
// Mirrors the per-vector hot loop of encoded_vectors_u8.rs:73-118
// BIT-FOR-BIT: IEEE f32 division (the reference's f32_to_u8 at :234-237 —
// note XLA's divide is NOT correctly rounded, so the device encoder can
// differ by one code at exact quantization boundaries; this host path is
// the byte-exact reference-interop encoder), clamp + trunc-toward-zero
// like `as u8`, padding to dpad with pad_code, and the per-vector
// correction term accumulated as a sequential f32 fold exactly like the
// Rust `iter().map(..).sum::<f32>()` (:94-109), negated when invert != 0.
// codes_out is [n, dpad] u8, voff_out is [n] f32.
void qtpu_quantize_u8(
    const float* data, int64_t n, int64_t dim, int64_t dpad,
    float alpha, float offset, uint8_t pad_code,
    int distance_type, int invert,
    uint8_t* codes_out, float* voff_out) {
  for (int64_t row = 0; row < n; ++row) {
    const float* v = data + row * dim;
    uint8_t* out = codes_out + row * dpad;
    float sum = 0.0f, sum_sq = 0.0f;
    for (int64_t j = 0; j < dim; ++j) {
      float q = (v[j] - offset) / alpha;
      q = std::min(std::max(q, 0.0f), 127.0f);
      if (std::isnan(q)) q = 0.0f;
      uint8_t code = (uint8_t)q;  // truncation toward zero, like `as u8`
      out[j] = code;
      sum += (float)code;
      sum_sq += (float)code * (float)code;
    }
    for (int64_t j = dim; j < dpad; ++j) {
      out[j] = pad_code;
      sum += (float)pad_code;
      sum_sq += (float)pad_code * (float)pad_code;
    }
    float voff;
    if (distance_type == 0) {  // Dot
      voff = (float)dpad * offset * offset + sum * alpha * offset;
    } else if (distance_type == 1) {  // L1
      voff = 0.0f;
    } else {  // L2
      voff = (float)dpad * offset * offset + sum_sq * alpha * alpha;
    }
    voff_out[row] = invert ? -voff : voff;
  }
}

// Sign-pack rows: bit i of byte i/8 set iff value > 0, little-endian bit
// order (encoded_vectors_binary.rs:199-207). rows_out is [n, row_bytes],
// zero-filled pad bytes included.
void qtpu_pack_bits(
    const float* data, int64_t n, int64_t dim, int64_t row_bytes,
    uint8_t* rows_out) {
  for (int64_t row = 0; row < n; ++row) {
    const float* v = data + row * dim;
    uint8_t* out = rows_out + row * row_bytes;
    std::memset(out, 0, (size_t)row_bytes);
    for (int64_t j = 0; j < dim; ++j) {
      if (v[j] > 0.0f) out[j >> 3] |= (uint8_t)(1u << (j & 7));
    }
  }
}

// Global min/max scan (quantile.rs:5-19).
void qtpu_min_max(const float* data, int64_t count,
                  float* min_out, float* max_out) {
  float mn = INFINITY, mx = -INFINITY;
  for (int64_t i = 0; i < count; ++i) {
    const float v = data[i];
    if (v < mn) mn = v;
    if (v > mx) mx = v;
  }
  *min_out = mn;
  *max_out = mx;
}

// Exact xor-popcount between two packed rows (reference scalar fallback,
// encoded_vectors_binary.rs:92-97) — used for host-side verification.
uint64_t qtpu_xor_popcount(const uint8_t* a, const uint8_t* b, int64_t nbytes) {
  uint64_t total = 0;
  int64_t i = 0;
  for (; i + 8 <= nbytes; i += 8) {
    uint64_t wa, wb;
    std::memcpy(&wa, a + i, 8);
    std::memcpy(&wb, b + i, 8);
    total += (uint64_t)__builtin_popcountll(wa ^ wb);
  }
  for (; i < nbytes; ++i) {
    total += (uint64_t)__builtin_popcount((unsigned)(a[i] ^ b[i]));
  }
  return total;
}

// ---------------------------------------------------------------------------
// CPU full-scan scorers. These reproduce the reference's scoring loops
// (scalar impl_score_dot / impl_score_l1 at encoded_vectors_u8.rs:456-474 and
// the xor-popcount scan) so the benchmark harness can measure a CPU baseline
// on this machine — the "reference CPU QPS" side of the >=10x/chip target —
// with -O3 -march=native autovectorization standing in for the hand-written
// SSE/AVX2 kernels.

void qtpu_cpu_scan_dot_u8(
    const uint8_t* query, const uint8_t* codes, int64_t n, int64_t dpad,
    float multiplier, float query_offset, const float* voffsets, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* v = codes + i * dpad;
    int32_t acc = 0;
    for (int64_t j = 0; j < dpad; ++j) {
      acc += (int32_t)query[j] * (int32_t)v[j];
    }
    out[i] = multiplier * (float)acc + query_offset + voffsets[i];
  }
}

void qtpu_cpu_scan_l1_u8(
    const uint8_t* query, const uint8_t* codes, int64_t n, int64_t dpad,
    float multiplier, float query_offset, const float* voffsets, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* v = codes + i * dpad;
    int32_t acc = 0;
    for (int64_t j = 0; j < dpad; ++j) {
      int32_t d = (int32_t)query[j] - (int32_t)v[j];
      acc += d < 0 ? -d : d;
    }
    out[i] = multiplier * (float)acc + query_offset + voffsets[i];
  }
}

// dist_mode encodes the metric map sign: out = sign * (dim - 2*xor) with
// sign=+1 for (Dot, !invert) and (L1/L2, invert), else -1.
void qtpu_cpu_scan_hamming(
    const uint8_t* query, const uint8_t* rows, int64_t n, int64_t row_bytes,
    float dim, float sign, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* v = rows + i * row_bytes;
    uint64_t x = qtpu_xor_popcount(query, v, row_bytes);
    out[i] = sign * (dim - 2.0f * (float)x);
  }
}

// f32 dot scan — the unquantized CPU baseline
// (demos/src/metrics/utils_avx2.rs dot_avx equivalent via autovectorization).
void qtpu_cpu_scan_dot_f32(
    const float* query, const float* data, int64_t n, int64_t dim,
    float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float* v = data + i * dim;
    float acc = 0.0f;
    for (int64_t j = 0; j < dim; ++j) acc += query[j] * v[j];
    out[i] = acc;
  }
}

int qtpu_abi_version() { return 2; }

}  // extern "C"
