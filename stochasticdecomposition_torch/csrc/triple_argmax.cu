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
// exactly as torch.argmax / torch.max(dim=0) do.  A masked-out entry takes
// the value -1e300 (it is not skipped), so a mask that selects nothing
// gives index 0 and -1e300.  Selection is in f64: the TPU kernel selected
// in f32 only because the TPU's vector unit has no f64.
//
// Bound.  The kernel reads H once (S*O*8 bytes) plus the masks and writes
// 6*O values: at the default configuration (S = 7501, O = 5120) that is
// ~307 MB, ~92 us at the H100's 3.35 TB/s.  It does ~3 compares per
// element, far below the card's arithmetic rate: it is memory-bound.
//
// Design.  Each block owns a tile of 32 consecutive columns; its threads
// are 32 columns x ROWS row groups.  A warp reads 32 consecutive doubles of
// one row (256 contiguous bytes, coalesced), and the mask bytes of that row
// are the same for the whole warp (one broadcast load).  Each thread walks
// its rows in increasing order keeping three running (value, index) pairs,
// so within a thread a tie keeps the earlier row.  The row groups are then
// reduced in shared memory with the full comparator (NaN first, then the
// larger value, then the smaller index).  One pass over H; no padding and
// no 128-lane tiling, which were Mosaic's constraints.  With one block per
// 32 columns the default shape gives 160 blocks of 1024 threads, about one
// block per SM: simple, not yet tuned for occupancy.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;
constexpr int ROWS = 32;
constexpr double NEG = -1e300;

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

__global__ void __launch_bounds__(COLS * ROWS)
triple_masked_argmax_kernel(const double* __restrict__ H,
                            const uint8_t* __restrict__ base,
                            const uint8_t* __restrict__ old_m,
                            const uint8_t* __restrict__ new_m,
                            int S, int O,
                            int64_t* __restrict__ i_all,
                            double* __restrict__ h_all,
                            int64_t* __restrict__ i_old,
                            double* __restrict__ h_old,
                            int64_t* __restrict__ i_new,
                            double* __restrict__ h_new) {
  __shared__ double sv[3][ROWS][COLS];
  __shared__ int si[3][ROWS][COLS];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int o = blockIdx.x * COLS + tx;
  const bool col_ok = o < O;

  // Running maxima; row ty is always this thread's first row (S >= ROWS is
  // not required: threads with no row keep the -inf/S sentinel, which any
  // real entry beats).
  double v0 = -CUDART_INF, v1 = -CUDART_INF, v2 = -CUDART_INF;
  int j0 = S, j1 = S, j2 = S;

  if (col_ok) {
    for (int s = ty; s < S; s += ROWS) {
      const double h = H[(size_t)s * O + o];
      const double a = base[s] ? h : NEG;
      const double b = old_m[s] ? h : NEG;
      const double c = new_m[s] ? h : NEG;
      // Rows arrive in increasing order: only a strictly better value
      // (or the first NaN) replaces the running pair.
      if (better(a, s, v0, j0)) { v0 = a; j0 = s; }
      if (better(b, s, v1, j1)) { v1 = b; j1 = s; }
      if (better(c, s, v2, j2)) { v2 = c; j2 = s; }
    }
  }
  sv[0][ty][tx] = v0; si[0][ty][tx] = j0;
  sv[1][ty][tx] = v1; si[1][ty][tx] = j1;
  sv[2][ty][tx] = v2; si[2][ty][tx] = j2;
  __syncthreads();

  // Tree reduction over the row groups.
  for (int half = ROWS / 2; half > 0; half >>= 1) {
    if (ty < half) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const double ov = sv[q][ty + half][tx];
        const int oi = si[q][ty + half][tx];
        if (better(ov, oi, sv[q][ty][tx], si[q][ty][tx])) {
          sv[q][ty][tx] = ov;
          si[q][ty][tx] = oi;
        }
      }
    }
    __syncthreads();
  }

  if (ty == 0 && col_ok) {
    i_all[o] = si[0][0][tx]; h_all[o] = sv[0][0][tx];
    i_old[o] = si[1][0][tx]; h_old[o] = sv[1][0][tx];
    i_new[o] = si[2][0][tx]; h_new[o] = sv[2][0][tx];
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError() after the launch; 0 means it was accepted.
// Requires S >= 1 and O >= 1; the Python wrapper checks shapes and types.
extern "C" int sd_triple_masked_argmax(const void* H, const void* base,
                                       const void* old_m, const void* new_m,
                                       int S, int O,
                                       void* i_all, void* h_all,
                                       void* i_old, void* h_old,
                                       void* i_new, void* h_new,
                                       void* stream) {
  const dim3 block(COLS, ROWS);
  const dim3 grid((O + COLS - 1) / COLS);
  triple_masked_argmax_kernel<<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(H), static_cast<const uint8_t*>(base),
      static_cast<const uint8_t*>(old_m), static_cast<const uint8_t*>(new_m),
      S, O,
      static_cast<int64_t*>(i_all), static_cast<double*>(h_all),
      static_cast<int64_t*>(i_old), static_cast<double*>(h_old),
      static_cast<int64_t*>(i_new), static_cast<double*>(h_new));
  return static_cast<int>(cudaGetLastError());
}
