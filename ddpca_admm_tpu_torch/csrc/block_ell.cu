// Batched Block-ELL SpMV for Hopper (sm_90a), with a plain C interface.
//
//   y[f, 8r + i] = sum_s sum_c tiles[f, r, s, i, c] * x[f, 128 cblk[f, r, s] + c]
//
// over F batch entries, n_rb row blocks of 8 rows and S slots per row block;
// each slot is a dense (8, 128) tile and the index of the 128-wide column
// block it covers.
//
// Replaces no Pallas kernel: it is the counterpart of an XLA op, the JAX
// package's BlockEll.mv (ddpca_admm_tpu/sparse/bell.py: a block gather
// xb[cblk] and an einsum at Precision.HIGHEST), which that package runs on
// every accelerator.  It was added because on the card the same product in
// plain torch is a gather, a copy of the tiles into the einsum's layout
// and a batched matrix product, several launches per call.
//
// What bounds it on an H100: memory.  It does 2 flops per tile entry, so
// the least time is the tiles, cblk, x and y moved once over the memory
// rate; the tiles are nearly all of it (a few percent of their entries are
// nonzero for hex8 operators, and the kernel reads them all).  The design
// keeps every tile byte to one coalesced 16-byte load:
//
//  * One warp per (batch entry, row block).  Lane l owns 4 columns of
//    every tile of its row block: 4l .. 4l+3 in float32 (one 16-byte
//    load), 2l, 2l+1, 64+2l, 64+2l+1 in float64 (two 16-byte loads, each
//    of which the warp takes as one contiguous 512-byte span).  Per slot
//    it loads those 4 values of x's column block (the warp reads the
//    block's 128 values once) and, for each of the 8 tile rows, the 4
//    tile values beside them, and keeps 8 partial sums, one per row.
//  * After the slots the warp reduces its 8 x 32 partial sums in 5 steps
//    of shuffles that halve the rows a lane holds (9 shuffles in all),
//    and the lanes 4k write the 8 rows.
//  * A batch axis of 1 on either side is a batch stride of 0: nothing is
//    copied for a broadcast.  No tensor cores: the JAX einsum runs at
//    HIGHEST precision, and TF32 would not keep it.
//
// tiles and x must start on 16 bytes (cudaErrorMisalignedAddress
// otherwise).  A cblk entry outside [0, n_cb) makes its row block's rows
// NaN.  Each entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kRB = 8;
constexpr int kCB = 128;
constexpr int kWarpsPerBlock = 8;

struct F4 {
  float v[4];
};
struct D4 {
  double v[4];
};

// a lane's 4 values of a 128-wide row, p at its first column, and the
// offset of that column
__device__ __forceinline__ F4 load4(const float* p) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  return F4{{a.x, a.y, a.z, a.w}};
}

__device__ __forceinline__ D4 load4(const double* p) {
  double2 a = __ldg(reinterpret_cast<const double2*>(p));
  double2 b = __ldg(reinterpret_cast<const double2*>(p + kCB / 2));
  return D4{{a.x, a.y, b.x, b.y}};
}

__device__ __forceinline__ int lane_col(const float*, int lane) {
  return 4 * lane;
}
__device__ __forceinline__ int lane_col(const double*, int lane) {
  return 2 * lane;
}

__device__ __forceinline__ void set_nan(float& v) {
  v = __int_as_float(0x7fc00000);
}
__device__ __forceinline__ void set_nan(double& v) {
  v = __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = F4;
};
template <>
struct Vec<double> {
  using type = D4;
};

// Halve the rows this lane holds: lanes with `bit` set keep the upper half
// of acc[0 .. 2*half), the others the lower half; each adds its partner's
// copy of the half it keeps.
template <typename T, int half>
__device__ __forceinline__ void fold(T* acc, int lane, int bit) {
  const bool upper = (lane & bit) != 0;
#pragma unroll
  for (int j = 0; j < half; ++j) {
    T send = upper ? acc[j] : acc[j + half];
    T keep = upper ? acc[j + half] : acc[j];
    acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    block_ell_mv_kernel(const T* __restrict__ tiles,
                        const int* __restrict__ cblk,
                        const T* __restrict__ x, T* __restrict__ y,
                        long long n_warps, int n_rb, int S, int n_cb,
                        long long ts, long long cs, long long xs) {
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (w >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const long long f = w / n_rb;
  const long long r = w - f * n_rb;
  const int col = lane_col(tiles, lane);
  const T* tp = tiles + f * ts + r * S * (kRB * kCB) + col;
  const int* cp = cblk + f * cs + r * S;
  const T* xp = x + f * xs + col;

  T acc[kRB];
#pragma unroll
  for (int i = 0; i < kRB; ++i) acc[i] = T(0);
  bool bad = false;
  for (int s = 0; s < S; ++s) {
    const int c = __ldg(cp + s);
    if (c < 0 || c >= n_cb) {
      bad = true;
      continue;
    }
    const typename Vec<T>::type xv =
        load4(xp + static_cast<long long>(c) * kCB);
    const T* ts_ = tp + static_cast<long long>(s) * (kRB * kCB);
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      const typename Vec<T>::type tv = load4(ts_ + i * kCB);
      T a = acc[i];
#pragma unroll
      for (int k = 0; k < 4; ++k) a = fma(tv.v[k], xv.v[k], a);
      acc[i] = a;
    }
  }
  // 8 rows x 32 lanes -> one row per lane group of 4: lane bits 4, 3, 2
  // pick the row, bits 1 and 0 are summed over
  fold<T, 4>(acc, lane, 16);
  fold<T, 2>(acc, lane, 8);
  fold<T, 1>(acc, lane, 4);
  T v = acc[0];
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  if (__any_sync(0xffffffffu, bad)) set_nan(v);
  if ((lane & 3) == 0) {
    const int row = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                    ((lane >> 2) & 1);
    y[w * kRB + row] = v;
  }
}

template <typename T>
int launch(const void* tiles, const void* cblk, const void* x, void* y, int F,
           int n_rb, int S, int n_cb, long long ts, long long cs,
           long long xs, void* stream) {
  const long long n_warps = static_cast<long long>(F) * n_rb;
  if (n_warps <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  block_ell_mv_kernel<T><<<static_cast<unsigned>(blocks),
                           kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tiles), static_cast<const int*>(cblk),
      static_cast<const T*>(x), static_cast<T*>(y), n_warps, n_rb, S, n_cb,
      ts, cs, xs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int block_ell_mv_f32(const void* tiles, const void* cblk,
                                const void* x, void* y, int F, int n_rb,
                                int S, int n_cb, long long ts, long long cs,
                                long long xs, void* stream) {
  return launch<float>(tiles, cblk, x, y, F, n_rb, S, n_cb, ts, cs, xs,
                       stream);
}

extern "C" int block_ell_mv_f64(const void* tiles, const void* cblk,
                                const void* x, void* y, int F, int n_rb,
                                int S, int n_cb, long long ts, long long cs,
                                long long xs, void* stream) {
  return launch<double>(tiles, cblk, x, y, F, n_rb, S, n_cb, ts, cs, xs,
                        stream);
}
