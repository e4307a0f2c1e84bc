// Triple masked argmax over the dual-vertex pool: the SD cut's argmax step.
//
// Replaces the TPU kernel `_triple_argmax_f32` of
// stochasticdecomposition_tpu/ops/pallas_argmax.py (pallas_call at l.191;
// bodies `_whole_kernel` l.74 and `_make_stream_kernel` l.86, reduction
// `_reduce3` l.55), which `core/cuts.py::form_cut` calls through
// `triple_masked_argmax` (l.201).
//
// What it computes.  H is the [S, O] height table (S dual vertices, O
// observations, f64, row-major).  For each column o and each of three masks
// over the rows (all valid vertices, "old" ones, "new" ones) it returns the
// index and the value of the maximum of where(mask[:, None], H, -1e300) over
// axis 0, the FIRST index on ties, and a NaN wins at its first occurrence,
// exactly as torch.argmax / torch.amax(dim=0) do.  A masked-out entry takes
// the value -1e300 at its own index (it is not skipped), so a mask that
// selects nothing gives index 0 and -1e300.  Selection is in f64: the TPU
// kernel selected in f32 only because the TPU's vector unit has no f64.
// Every merge below uses one strict total order on (value, index): NaN
// first (smaller index among NaNs), then the larger value, then the
// smaller index.  So the result does not depend on how the rows are split
// or in which order the pieces are merged, and equals the plain version's.
//
// Bound.  Memory: the function must read the rows some mask selects (the
// others are -1e300 at their own index whatever H holds there), the three
// masks, and write 6 [O] outputs: n_sel*O*8 + 3*S + 48*O bytes over the
// H100's 3.35 TB/s.  With every row selected at the main path's capacity
// (S = 7501, O = 5120) that is ~307 MB, ~92 us.  A few compares per
// element, far below the card's arithmetic rate.
//
// Design, against the three limits of the first version (one block per 32
// columns walking all S rows with one 8-byte load per thread per row):
//  1. Bytes in flight.  Each block is one producer warp and 8 consumer
//     warps.  The producer streams the block's rows through a ring of
//     STAGES = 3 shared-memory stages of TR = 32 rows x TC = 128 columns
//     (32 KB) with TMA (cp.async.bulk.tensor.2d, completion on an
//     mbarrier); the consumers reduce the stage that has landed and
//     release it on a second mbarrier.  Up to 3 tiles per block, and 2
//     blocks per SM, are in flight.  Where TMA cannot address H (a row
//     stride that is not a multiple of 16 bytes, i.e. odd O, or an
//     unaligned base) the producer fills the same ring with 8-byte cp.async
//     copies of the selected rows instead.
//  2. Balance.  The grid is O-tiles x S-splits, so the pool dimension is
//     split across blocks.  Split c takes the row tiles c, c + n_splits,
//     c + 2 n_splits, ... (interleaved, not a contiguous range), so that
//     the selected rows, which on the main path are a prefix of the pool,
//     spread over every split.  ops/argmax.py::split_plan chooses n_splits
//     so that the grid is one wave of equal blocks.  Each block writes
//     three (value, index) partials per column to a workspace
//     [n_splits, 3, O]; the last block of each O-tile (an atomic ticket
//     after __threadfence) merges them.
//  3. Rows no mask selects.  The block packs the three masks into one code
//     per row (bit0 all, bit1 old, bit2 new) in shared memory.  The
//     producer skips every row tile whose codes are all 0: such a tile's
//     best candidate for every mask is (-1e300, its first row), and only
//     the block's first such tile can matter.  Within a loaded tile a row
//     outside mask q enters reduction q as (-1e300, s).  On the main path
//     the rows past sigma_cnt are in no mask, so a launch reads about
//     sigma_cnt*O*8 bytes instead of the whole capacity table.
//
// Build.  nvcc 12.9 -Xptxas -v for sm_90a: 40 registers, 13,504 bytes of
// static shared memory (plus 98,432 dynamic: the ring), no stack frame, no
// spills.  chip_smoke.py's build phase prints these lines.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TR = 32;                 // rows per ring stage (one TMA box)
constexpr int NC = 256;                // consumer threads
constexpr int NT = NC + 32;            // plus one producer warp
constexpr int MAX_TILES = 128;         // row tiles (of codes) a block stages
constexpr int NONE = 0x7fffffff;       // "no candidate yet" index
constexpr double NEG = -1e300;
static_assert(TR == 32, "a tile's liveness is one warp vote");

constexpr int TC = 128;                // columns per O-tile (1 KB a row)
constexpr int STAGES = 3;              // ring stages of TR x TC f64 (32 KB)
constexpr int G = NC / TC;             // row groups of the consumers
constexpr int STAGE_ELEMS = TR * TC;
constexpr int STAGE_BYTES = STAGE_ELEMS * 8;
constexpr int SMEM = STAGES * STAGE_BYTES + 128;  // + alignment slack

struct Params {
  const double* H;
  const uint8_t* base;
  const uint8_t* old_m;
  const uint8_t* new_m;
  int S, O, n_splits, n_otiles, use_tma;
  int64_t* idx[3];
  double* val[3];
  double* ws_val;    // [n_splits, 3, O]   (n_splits > 1 only)
  int* ws_idx;       // [n_splits, 3, O]
  int* ticket;       // [n_otiles], zero before the launch
};

// Is (a, ia) a better maximum than (b, ib)?  NaN beats numbers; among
// NaNs, and among equal values, the smaller index wins.
__device__ __forceinline__ bool better(double a, int ia, double b, int ib) {
  const bool an = a != a;
  const bool bn = b != b;
  if (an || bn) {
    if (an && bn) return ia < ib;
    return an;
  }
  return a > b || (a == b && ia < ib);
}

// The same order when the candidates of one thread arrive in increasing
// row order: the first one, then a NaN over a number, then a strictly
// larger value.
__device__ __forceinline__ void take(double& v, int& j, double a, int s) {
  if (j == NONE || (v == v && !(a <= v))) {
    v = a;
    j = s;
  }
}

// Output q at column o.  The pointer is chosen by branches: indexing the
// parameter arrays with a run-time q would copy them to local memory.
__device__ __forceinline__ void store(const Params& p, int q, int o,
                                      double v, int j) {
  int64_t* idx = q == 0 ? p.idx[0] : q == 1 ? p.idx[1] : p.idx[2];
  double* val = q == 0 ? p.val[0] : q == 1 ? p.val[1] : p.val[2];
  idx[o] = j;
  val[o] = v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of the given parity has completed.  A wait of
// more than ~2^34 cycles (seconds) can only be a fault of the pipeline: it
// traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1LL << 34))
      __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void cp_async_8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// The barrier counts this thread's arrival once its earlier cp.async
// copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__global__ void __launch_bounds__(NT)
    triple_argmax_kernel(const __grid_constant__ CUtensorMap tmap,
                         const Params p) {
  extern __shared__ unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ uint8_t s_code[MAX_TILES * TR];
  __shared__ uint8_t s_live[MAX_TILES];
  __shared__ int s_first_dead, s_last;
  __shared__ double red_v[3][NC];
  __shared__ int red_i[3][NC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int otile = blockIdx.x % p.n_otiles;
  const int split = blockIdx.x / p.n_otiles;
  const int col0 = otile * TC;
  // This block's row tiles: split, split + n_splits, ... (local tile i is
  // the global tile split + i * n_splits, rows from TR times that).
  const int n_tiles = (p.S + TR - 1) / TR;
  const int nt = (n_tiles - split + p.n_splits - 1) / p.n_splits;
  const int rows = nt * TR;

  if (tid == 0) {
    s_first_dead = NONE;
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full_bar[st], p.use_tma ? 1 : 32);
      mbar_init(&empty_bar[st], NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // One code per row of the block's tiles: bit0 all, bit1 old, bit2 new
  // (0 past the last row).  Up to 8 rows per thread per pass, all loads
  // first: one pass (one memory latency) for up to 72 tiles.
  for (int r0 = tid; r0 < rows; r0 += 8 * NT) {
    uint8_t b[8], o[8], n[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = r0 + k * NT;
      const int s = (split + (r / TR) * p.n_splits) * TR + r % TR;
      const bool in = r < rows && s < p.S;
      b[k] = in ? p.base[s] : 0;
      o[k] = in ? p.old_m[s] : 0;
      n[k] = in ? p.new_m[s] : 0;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = r0 + k * NT;
      if (r < rows)
        s_code[r] = static_cast<uint8_t>((b[k] ? 1 : 0) | (o[k] ? 2 : 0) |
                                         (n[k] ? 4 : 0));
    }
  }
  __syncthreads();
  // A tile is live when some row of it is in some mask.
  for (int i = warp; i < nt; i += NT / 32) {
    const bool live = __any_sync(0xffffffffu, s_code[i * TR + lane] != 0);
    if (lane == 0) {
      s_live[i] = live;
      if (!live) atomicMin(&s_first_dead, i);
    }
  }
  __syncthreads();

  if (warp == NC / 32) {
    // Producer: fill the ring with the live tiles, in row order.
    int st = 0;
    uint32_t ph = 0;
    if (p.use_tma) {
      if (lane == 0) {
        for (int i = 0; i < nt; ++i) {
          if (!s_live[i]) continue;
          mbar_wait(&empty_bar[st], ph ^ 1);
          mbar_expect_tx(&full_bar[st], STAGE_BYTES);
          tma_load_2d(ring + st * STAGE_ELEMS, &tmap, &full_bar[st], col0,
                      (split + i * p.n_splits) * TR);
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    } else {
      const int ncols = min(TC, p.O - col0);
      for (int i = 0; i < nt; ++i) {
        if (!s_live[i]) continue;
        mbar_wait(&empty_bar[st], ph ^ 1);
        double* dst = ring + st * STAGE_ELEMS;
        const int s0 = (split + i * p.n_splits) * TR;
        for (int r = 0; r < TR; ++r) {
          if (!s_code[i * TR + r]) continue;
          const double* src = p.H + static_cast<size_t>(s0 + r) * p.O + col0;
          for (int c = lane; c < ncols; c += 32)
            cp_async_8(dst + r * TC + c, src + c);
        }
        cp_async_arrive(&full_bar[st]);
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // Consumers: thread (g, c) reduces rows g, g + G, ... of column c of
    // each stage; a warp reads 32 consecutive doubles of one row.
    const int c = tid % TC;
    const int g = tid / TC;
    double v0 = -CUDART_INF, v1 = -CUDART_INF, v2 = -CUDART_INF;
    int j0 = NONE, j1 = NONE, j2 = NONE;
    int st = 0;
    uint32_t ph = 0;
    for (int i = 0; i < nt; ++i) {
      if (!s_live[i]) continue;
      mbar_wait(&full_bar[st], ph);
      const double* tile = ring + st * STAGE_ELEMS;
      const uint8_t* code = s_code + i * TR;
      const int s0 = (split + i * p.n_splits) * TR;
      const int nr = min(TR, p.S - s0);
#pragma unroll 4
      for (int r = g; r < nr; r += G) {
        const unsigned m = code[r];
        // A row in no mask is not read (the copy may have skipped it).
        const double h = m ? tile[r * TC + c] : NEG;
        take(v0, j0, (m & 1) ? h : NEG, s0 + r);
        take(v1, j1, (m & 2) ? h : NEG, s0 + r);
        take(v2, j2, (m & 4) ? h : NEG, s0 + r);
      }
      mbar_arrive(&empty_bar[st]);
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
    red_v[0][tid] = v0;
    red_i[0][tid] = j0;
    red_v[1][tid] = v1;
    red_i[1][tid] = j1;
    red_v[2][tid] = v2;
    red_i[2][tid] = j2;
  }
  __syncthreads();

  // Merge the row groups and the first row of the block's first dead tile
  // (a block with no live tile gives (-1e300, its first row)).
  const bool merged = p.n_splits == 1;
  for (int k = tid; k < 3 * TC; k += NT) {
    const int q = k / TC;
    const int c = k % TC;
    const int o = col0 + c;
    double v = -CUDART_INF;
    int j = NONE;
    if (s_first_dead != NONE) {
      v = NEG;
      j = (split + s_first_dead * p.n_splits) * TR;
    }
    for (int g = 0; g < G; ++g) {
      const double a = red_v[q][g * TC + c];
      const int ia = red_i[q][g * TC + c];
      if (better(a, ia, v, j)) {
        v = a;
        j = ia;
      }
    }
    if (o >= p.O) continue;
    if (merged) {
      store(p, q, o, v, j);
    } else {
      const size_t w = (static_cast<size_t>(split) * 3 + q) * p.O + o;
      p.ws_val[w] = v;
      p.ws_idx[w] = j;
    }
  }
  if (merged) return;

  // The last block of this O-tile to finish merges the splits' partials.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.ticket[otile], 1) == p.n_splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // Each thread merges up to PER (mask, column) pairs, their loads for a
  // split issued together.
  constexpr int PER = (3 * TC + NT - 1) / NT;
  double v[PER];
  int j[PER];
  size_t w0[PER];
  bool ok[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int k = tid + u * NT;
    const int o = col0 + k % TC;
    ok[u] = k < 3 * TC && o < p.O;
    w0[u] = static_cast<size_t>(k / TC) * p.O + o;
    v[u] = -CUDART_INF;
    j[u] = NONE;
  }
  const size_t stride = static_cast<size_t>(3) * p.O;
#pragma unroll 4
  for (int sp = 0; sp < p.n_splits; ++sp) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      if (!ok[u]) continue;
      const size_t w = sp * stride + w0[u];
      const double a = __ldcg(&p.ws_val[w]);
      const int ia = __ldcg(&p.ws_idx[w]);
      if (better(a, ia, v[u], j[u])) {
        v[u] = a;
        j[u] = ia;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int k = tid + u * NT;
    if (ok[u]) store(p, k / TC, col0 + k % TC, v[u], j[u]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The split plan (n_splits,
// use_tma) comes from ops/argmax.py::split_plan; with n_splits > 1 the
// caller passes the workspace ws_val f64 / ws_idx int32 [n_splits, 3, O]
// and a zeroed ticket int32 [n_otiles].
// Launches on `stream` and returns cudaGetLastError() after the launch (0:
// accepted), -1 for a plan the kernel does not take, -2 when
// cuTensorMapEncodeTiled is unavailable, and -1000 - r when it returns the
// CUresult r.
extern "C" int sd_triple_masked_argmax(
    const void* H, const void* base, const void* old_m, const void* new_m,
    int S, int O, int n_splits, int use_tma, void* i_all,
    void* h_all, void* i_old, void* h_old, void* i_new, void* h_new,
    void* ws_val, void* ws_idx, void* ticket, void* stream) {
  if (S < 1 || O < 1) return -1;
  const long long n_tiles = (static_cast<long long>(S) + TR - 1) / TR;
  if (n_splits < 1 || n_splits > n_tiles ||
      (n_tiles + n_splits - 1) / n_splits > MAX_TILES)
    return -1;
  const int n_otiles = (O + TC - 1) / TC;
  const long long blocks = static_cast<long long>(n_splits) * n_otiles;
  if (blocks >= (1LL << 31)) return -1;
  if (n_splits > 1 && (!ws_val || !ws_idx || !ticket)) return -1;

  Params p;
  p.H = static_cast<const double*>(H);
  p.base = static_cast<const uint8_t*>(base);
  p.old_m = static_cast<const uint8_t*>(old_m);
  p.new_m = static_cast<const uint8_t*>(new_m);
  p.S = S;
  p.O = O;
  p.n_splits = n_splits;
  p.n_otiles = n_otiles;
  p.use_tma = use_tma;
  p.idx[0] = static_cast<int64_t*>(i_all);
  p.val[0] = static_cast<double*>(h_all);
  p.idx[1] = static_cast<int64_t*>(i_old);
  p.val[1] = static_cast<double*>(h_old);
  p.idx[2] = static_cast<int64_t*>(i_new);
  p.val[2] = static_cast<double*>(h_new);
  p.ws_val = static_cast<double*>(ws_val);
  p.ws_idx = static_cast<int*>(ws_idx);
  p.ticket = static_cast<int*>(ticket);

  CUtensorMap tmap;
  memset(&tmap, 0, sizeof(tmap));
  if (use_tma) {
    // TMA needs a 16-byte aligned base and row stride.
    if (reinterpret_cast<uintptr_t>(H) % 16 != 0 ||
        (static_cast<size_t>(O) * 8) % 16 != 0)
      return -1;
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return -2;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(O),
                                static_cast<cuuint64_t>(S)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(O) * 8};
    const cuuint32_t box[2] = {TC, TR};
    const cuuint32_t elem_strides[2] = {1, 1};
    const CUresult r = encode(
        &tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 2, const_cast<void*>(H), dims,
        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -1000 - static_cast<int>(r);
  }
  cudaError_t err = cudaFuncSetAttribute(
      triple_argmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  triple_argmax_kernel<<<static_cast<int>(blocks), NT, SMEM,
                         static_cast<cudaStream_t>(stream)>>>(tmap, p);
  return static_cast<int>(cudaGetLastError());
}
