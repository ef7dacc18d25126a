// Batched PlaneDia SpMV for Hopper (sm_90a), with a plain C interface.
//
//   y[b, z*P + p] = sum_d vals[kz[b, z], d, p] * x[b, z*P + p + off_d]
//
// for the active rows z*P + p < nz*P of every body b; x counts as 0 outside
// [0, nz*P).  The rows past nz*P (the hierarchy's padded tail) copy x
// (tail_identity) or are 0; the same launch writes them.
//
// Replaces the Pallas TPU kernel ddpca_admm_tpu/sparse/pallas_dia.py::_kernel
// (launched by plane_dia_mv_pallas), which kept the whole (C, D, P) class
// table resident in VMEM so that each slab was read once per launch.
//
// What bounds it on an H100: memory.  It does 2 flops for each value of the
// table it reads, so the least time is the bytes over the memory rate: the
// (C, D, P) table once, x and y once each.  The table is the bulk of them
// (28.9 MB of 31.5 MB for the f64 A_top at 180k DOF; 205 MB for the f32
// finest level at 8.8M DOF, four times the 50 MB L2).  So the design reads
// each class slab once per work item, not once per (body, plane):
//
//  * The host plan (sparse/dia.py, built once per operator) sorts the
//    (body, plane) pairs by class and cuts each class's list into work
//    items of at most CAP planes (fewer for a small operator, so that its
//    launch still has a few blocks per SM).  A block takes one work item
//    and one tile of 32*V plane columns (V = 16 bytes / itemsize: 4 floats
//    or 2 doubles), brings the item's table slab for the tile from memory
//    once and applies it to every plane of the item.  Table bytes per
//    launch are then (work items / classes) x the table, not (planes /
//    classes) x.
//  * The offsets are cut on the host into groups of WINDOW consecutive
//    shifts (a hex8 stiffness has 9 runs of 11 consecutive offsets; a
//    transfer stencil 9 runs of 3 shifts 3 apart); a slot the operator does
//    not have holds 0.  The three warps of a block take the groups in turn.
//  * For its group a warp brings into shared memory, in one batch of bulk
//    copies (the copy engine, cp.async.bulk, reporting to one mbarrier per
//    warp), the 16-byte aligned spans that hold the tile's columns of the
//    group's table rows and, for every plane of the item, the tile's window
//    of x.  One lane issues each copy, so a warp pays one load latency per
//    group and a few instructions per span, not per value.  A span that
//    reaches outside the body's active rows (x is 0 there) or the table is
//    staged by plain loads instead.
//  * From shared memory a lane takes its V columns of each row and the
//    WINDOW + V - 1 values of x they need with 16-byte loads, moves them to
//    their place with selects on the span's misalignment (no branch, no
//    offsets read per term), and adds WINDOW x V independent products into
//    CAP x V partial sums.  At the end the warps add their partial sums in
//    shared memory and write y with 16-byte stores where aligned.
//  * Blocks past the work items copy or zero the tail rows: one launch per
//    call.
//
// Where the limits stand: at 180k DOF the table sits in L2 and a launch of
// a few hundred blocks is bound by load latency (a warp pays one round trip
// per group, three groups in turn); at 8.8M DOF the chains of a warp (copy,
// wait, compute) with 15 warps per SM leave the memory rate unfilled, and
// a table slab is read again for each work item of its class.
//
// vals and x must start on 16 bytes (cudaErrorMisalignedAddress
// otherwise).  Each entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue, without launching, when the caller's plan was
// built for another WINDOW or CAP).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WINDOW = 12;  // shifts per offset group (the host plan's)
constexpr int CAP = 8;      // planes per work item (the host plan's)
constexpr int WARPS = 3;    // warps per block, taking the groups in turn
constexpr int THREADS = 32 * WARPS;
constexpr int TAIL_BLOCKS_MAX = 1024;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  typedef float4 type;
  static __device__ __forceinline__ void split(const float4& q, float* w) {
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  }
  static __device__ __forceinline__ float4 join(const float* w) {
    return make_float4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Vec<double> {
  typedef double2 type;
  static __device__ __forceinline__ void split(const double2& q, double* w) {
    w[0] = q.x; w[1] = q.y;
  }
  static __device__ __forceinline__ double2 join(const double* w) {
    return make_double2(w[0], w[1]);
  }
};

// w[i] = a[i] for i < NV * V: NV 16-byte loads, a 16-byte aligned
template <typename T, int NV>
__device__ __forceinline__ void load_vecs(const T* a, T* w) {
  constexpr int V = 16 / sizeof(T);
  typedef typename Vec<T>::type VT;
  const VT* av = reinterpret_cast<const VT*>(a);
#pragma unroll
  for (int i = 0; i < NV; ++i) Vec<T>::split(av[i], w + i * V);
}

// out[i] = w[mis + i] for i < N, 0 <= mis < V, w holding N + V - 1 values:
// selects by the bits of mis, no branch and no indexing by a register
template <typename T, int N>
__device__ __forceinline__ void shift(const T* w, int mis, T* out) {
  if constexpr (16 / sizeof(T) == 4) {
    T t[N + 2];
#pragma unroll
    for (int i = 0; i < N + 2; ++i) t[i] = (mis & 1) ? w[i + 1] : w[i];
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = (mis & 2) ? t[i + 2] : t[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = (mis & 1) ? w[i + 1] : w[i];
  }
}

// The span src[a0 .. a0 + n) into dst (16-byte aligned, shared), the
// values outside [vlo, vhi) as 0, by plain loads and stores of the warp
template <typename T>
__device__ __forceinline__ void stage_span(T* dst, const T* src, int64_t a0,
                                           int n, int64_t vlo, int64_t vhi,
                                           int lane) {
  for (int e = lane; e < n; e += 32) {
    const int64_t r = a0 + e;
    dst[e] = (r >= vlo && r < vhi) ? src[r] : T(0);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory that reports to the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 5)
plane_dia_mv_kernel(const T* __restrict__ vals,
                    const int32_t* __restrict__ pairs,
                    const int32_t* __restrict__ items,
                    const int32_t* __restrict__ groups,
                    const T* __restrict__ x, T* __restrict__ y,
                    int nz, int P, int D, int G, int n_work, int n_tiles,
                    int64_t n_table, int64_t n_rows, int64_t n_tail,
                    int tail_identity) {
  constexpr int V = 16 / sizeof(T);
  constexpr int TILE = 32 * V;              // plane columns per block
  constexpr int NW = WINDOW + V - 1;        // x values a lane needs
  constexpr int NXV = (NW + 2 * V - 2) / V;   // 16-byte loads that hold them
  constexpr int XCH = 32 + (NW + V - 1) / V;  // 16-byte chunks of x staged
                                              // per plane
  constexpr int TCH = 33;                     // ... of a table row's tile
  const int64_t na = (int64_t)nz * P;
  const int bid = blockIdx.x;

  if (bid >= n_work) {  // the tail rows [na, n_rows) of every body
    const int64_t tail = n_rows - na;
    const int64_t step = (int64_t)(gridDim.x - n_work) * THREADS;
    for (int64_t i = (int64_t)(bid - n_work) * THREADS + threadIdx.x;
         i < n_tail; i += step) {
      const int64_t b = i / tail;
      const int64_t r = b * n_rows + na + (i - b * tail);
      y[r] = tail_identity ? x[r] : T(0);
    }
    return;
  }

  // per warp: the 16-byte chunks that hold the tile's columns of its
  // group's table rows and, for every plane of the item, the tile's window
  // of x for the group; at the end the x area holds the warps' partial sums
  __shared__ __align__(16) T s_x[WARPS][CAP][XCH * V];
  __shared__ __align__(16) T s_tab[WARPS][WINDOW][TCH * V];
  __shared__ int s_gd[WARPS][WINDOW + 1];
  __shared__ __align__(8) unsigned long long s_bar[WARPS];
  __shared__ long long s_lo[CAP];   // first row of plane j's body
  __shared__ long long s_row[CAP];  // row of plane j's column 0
  static_assert(CAP + WINDOW <= 32 && (CAP & (CAP - 1)) == 0,
                "a lane per x window and per table row");
  static_assert(sizeof(s_x) >= sizeof(T) * WARPS * CAP * V * 32,
                "the partial sums must fit the staging area");

  const int item = bid / n_tiles;
  const int tile = bid - item * n_tiles;
  const int c = items[3 * item];
  const int first = items[3 * item + 1];
  const int cnt = items[3 * item + 2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < cnt) {
    const int pr = pairs[first + threadIdx.x];
    const int b = pr / nz;
    const int z = pr - b * nz;
    s_lo[threadIdx.x] = (long long)b * n_rows;
    s_row[threadIdx.x] = (long long)b * n_rows + (long long)z * P;
  }
  if (warp < G && lane <= WINDOW)
    s_gd[warp][lane] = groups[warp * (WINDOW + 1) + lane];
  const unsigned bar = smem_addr(&s_bar[warp]);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned phase = 0;

  const int p0 = tile * TILE;
  const int pc = p0 + V * lane;  // this lane's first column
  const bool full = pc + V <= P;
  const int64_t vr = (int64_t)c * D * P + p0;  // the tile of table row 0

  T acc[CAP][V];
#pragma unroll
  for (int j = 0; j < CAP; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[j][v] = T(0);

  for (int g = warp; g < G; g += WARPS) {
    const int g0 = s_gd[warp][0];
    // One bulk copy per x window and per table row, lane j taking plane
    // j's window and lane CAP + k row k, all reporting to the warp's
    // mbarrier; a window or row that reaches outside the body's active
    // rows (or the table) is staged by plain loads instead.
    const int64_t xa = (s_row[lane & (CAP - 1)] + p0 + g0) &
                       ~(int64_t)(V - 1);
    const int64_t xlo = s_lo[lane & (CAP - 1)];
    const bool x_bulk = xa >= xlo && xa + XCH * V <= xlo + na;
    const int kk = lane - CAP;
    const int d = (kk >= 0 && kk < WINDOW) ? s_gd[warp][1 + kk] : -1;
    const int64_t ta = (vr + (int64_t)(d < 0 ? 0 : d) * P) &
                       ~(int64_t)(V - 1);
    const bool t_bulk = d >= 0 && ta + TCH * V <= n_table;
    const bool mine_x = lane < cnt && x_bulk;
    const unsigned bytes = __reduce_add_sync(
        0xffffffffu, (mine_x ? XCH * 16u : 0u) + (t_bulk ? TCH * 16u : 0u));
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar), "r"(bytes)
                   : "memory");
    __syncwarp();
    if (mine_x || t_bulk)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (mine_x)
      bulk_copy(&s_x[warp][lane][0], x + xa, XCH * 16u, bar);
    if (t_bulk)
      bulk_copy(&s_tab[warp][kk][0], vals + ta, TCH * 16u, bar);
    const unsigned x_plain = __ballot_sync(0xffffffffu,
                                           lane < cnt && !x_bulk);
    const unsigned t_plain = __ballot_sync(0xffffffffu, d >= 0 && !t_bulk);
    for (int j = 0; j < cnt; ++j)
      if (x_plain >> j & 1) {
        const int64_t a0 = (s_row[j] + p0 + g0) & ~(int64_t)(V - 1);
        stage_span(&s_x[warp][j][0], x, a0, XCH * V, s_lo[j], s_lo[j] + na,
                   lane);
      }
    for (int k = 0; k < WINDOW; ++k)
      if (t_plain >> (CAP + k) & 1) {
        const int64_t a0 =
            (vr + (int64_t)s_gd[warp][1 + k] * P) & ~(int64_t)(V - 1);
        stage_span(&s_tab[warp][k][0], vals, a0, TCH * V, 0, n_table, lane);
      }
    const int gn = g + WARPS;  // the next group's descriptor, in flight
    const int next = (gn < G && lane <= WINDOW)
                         ? __ldg(groups + gn * (WINDOW + 1) + lane) : 0;
    bar_wait(bar, phase);
    phase ^= 1;
    __syncwarp();

    // this lane's V columns of the group's rows
    T tab[WINDOW][V];
#pragma unroll
    for (int k = 0; k < WINDOW; ++k) {
      const int d = s_gd[warp][1 + k];
      if (d < 0) {
#pragma unroll
        for (int v = 0; v < V; ++v) tab[k][v] = T(0);
      } else {
        T w[2 * V];
        load_vecs<T, 2>(&s_tab[warp][k][V * lane], w);
        shift<T, V>(w, (int)((vr + (int64_t)d * P) & (V - 1)), tab[k]);
      }
    }

#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      if (j < cnt) {
        T w[NXV * V];
        T e[NW];
        load_vecs<T, NXV>(&s_x[warp][j][V * lane], w);
        shift<T, NW>(w, (int)((s_row[j] + p0 + g0) & (V - 1)), e);
#pragma unroll
        for (int k = 0; k < WINDOW; ++k)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[j][v] = fma(tab[k][v], e[k + v], acc[j][v]);
      }
    }
    __syncwarp();
    if (lane <= WINDOW) s_gd[warp][lane] = next;
    __syncwarp();
  }

  // add the warps' partial sums; warp w stores planes w, w + WARPS, ...
  __syncthreads();
  T(*red)[CAP][V][32] = reinterpret_cast<T(*)[CAP][V][32]>(&s_x[0][0][0]);
#pragma unroll
  for (int j = 0; j < CAP; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) red[warp][j][v][lane] = acc[j][v];
  __syncthreads();
  for (int j = warp; j < cnt; j += WARPS) {
    T out[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      T s = T(0);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w][j][v][lane];
      out[v] = s;
    }
    T* yr = y + s_row[j] + pc;
    if (full && (reinterpret_cast<uintptr_t>(yr) & 15) == 0) {
      *reinterpret_cast<typename Vec<T>::type*>(yr) = Vec<T>::join(out);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (pc + v < P) yr[v] = out[v];
    }
  }
}

template <typename T>
int launch(const void* vals, const void* pairs, const void* items,
           const void* groups, const void* x, void* y, int B, int C, int nz,
           int P, int D, int G, int n_items, long long n_rows,
           int tail_identity, int window, int cap, void* stream) {
  if (window != WINDOW || cap != CAP || B <= 0 || nz <= 0 || P <= 0 ||
      C <= 0 || G <= 0 || n_items <= 0 || n_rows < (long long)nz * P)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(x)) &
      15)
    return (int)cudaErrorMisalignedAddress;
  constexpr int V = 16 / sizeof(T);
  const long long n_tiles = (P + 32 * V - 1) / (32 * V);
  const long long n_work = (long long)n_items * n_tiles;
  const long long n_tail = (long long)B * (n_rows - (long long)nz * P);
  long long tail_blocks = (n_tail + THREADS - 1) / THREADS;
  if (tail_blocks > TAIL_BLOCKS_MAX) tail_blocks = TAIL_BLOCKS_MAX;
  const long long blocks = n_work + tail_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  plane_dia_mv_kernel<T><<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const T*)vals, (const int32_t*)pairs, (const int32_t*)items,
      (const int32_t*)groups, (const T*)x, (T*)y, nz, P, D, G, (int)n_work,
      (int)n_tiles, (int64_t)C * D * P, (int64_t)n_rows, (int64_t)n_tail,
      tail_identity);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int plane_dia_mv_f32(const void* vals, const void* pairs,
                                const void* items, const void* groups,
                                const void* x, void* y, int B, int C, int nz,
                                int P, int D, int G, int n_items,
                                long long n_rows,
                                int tail_identity, int window, int cap,
                                void* stream) {
  return launch<float>(vals, pairs, items, groups, x, y, B, C, nz, P, D,
                       G, n_items, n_rows, tail_identity, window, cap,
                       stream);
}

extern "C" int plane_dia_mv_f64(const void* vals, const void* pairs,
                                const void* items, const void* groups,
                                const void* x, void* y, int B, int C, int nz,
                                int P, int D, int G, int n_items,
                                long long n_rows,
                                int tail_identity, int window, int cap,
                                void* stream) {
  return launch<double>(vals, pairs, items, groups, x, y, B, C, nz, P, D,
                        G, n_items, n_rows, tail_identity, window, cap,
                        stream);
}
