// The batched search's two walks, for Hopper: the lockstep PUCT selection
// below the root (S1b, select_walk) and the parent-chain backup (S1c,
// backup_walk).
//
// Not TPU kernels: the JAX search runs both walks as lax.while_loops inside
// its jitted simulation (twixt_for_open_spiel_tpu/models/mcts.py:368 with
// _best_edge at :244, and :511), which XLA fuses.  The port ran them as
// host loops of torch ops with one host read an iteration; an H100 profile
// of the search named the reads (PERF.md §5), so each walk is one launch
// here and a simulation reads nothing back.
//
// Semantics: ops/search_walk.py::select_walk_reference and
// backup_walk_reference (the plain torch versions), bit for bit.
//
// Layout: the search tree's arrays, env leading, contiguous:
//   uprior f32 [B, nodes, A]; visit i32, value_sum f32, parent i64, pa i64,
//   e_prior f32, terminal bool, tval f32, linked bool [B, nodes].
//
// select_walk.  One warp an env, from the root entry (action, kid,
// kid_term) a root rule chose: while the chosen child exists and is not
// terminal, step into it and score its edges.  The unexpanded edges are the
// masked-prior row (lanes over the A actions, coalesced), the expanded ones
// are scored child-side (lanes over the node slots whose parent is the
// node); each pass ends in a shuffle reduction that keeps torch's argmax:
// the first of equal maxima, NaN above everything.  The scores keep the
// plain version's float order with no contraction (__fmul_rn, __fdiv_rn,
// __fadd_rn, __fsqrt_rn): sc_u = (c_puct*up)*sq, q = -value_sum/max(visit,1)
// (tval on a terminal child), u = ((c_puct*e_prior)*sq)/(1+visit), q+u; a
// tie between an expanded and an unexpanded edge goes to the lower action.
// Each env adds 1 + its descents, the plain loop's iteration count, to a
// per-simulation maximum (``iters``, may be null).
//
// backup_walk.  One thread an env adds a visit and the value, negated at
// each level, from its leaf up the parent chain: one float add a node, as
// the plain loop, and writes its walk's length.  The plain loop runs until
// the longest walk ends and adds +0.0 at slot 0 of every env that finished
// earlier (a -0.0 sum becomes +0.0); the wrapper repeats that add from the
// lengths with torch ops on the device.
//
// What bounds them on this card: at the search's shapes (board 12, B=512,
// 65 slots) a descent reads a 576-byte prior row and about 1.7 KB of slot
// arrays an env, and a backup a few dozen bytes an env: far under a
// microsecond of HBM time.  The walks are chains of dependent loads, so
// their latency and the launch set the time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ops/_cuda.py).  Plain C entry points, bound with
// ctypes; no PyTorch headers.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WALK_ENVS_PER_BLOCK = 4;  // warps
constexpr int BACKUP_THREADS = 64;

// (a, ia) before (b, ib) in torch's argmax order: NaN is the largest value,
// and of equal values the lower index wins.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

// The warp's best (value, index): every lane ends with it.
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(WALK_ENVS_PER_BLOCK * WARP) select_walk_kernel(
    const float* __restrict__ uprior, const int* __restrict__ visit,
    const float* __restrict__ value_sum, const long long* __restrict__ parent,
    const long long* __restrict__ pa, const float* __restrict__ e_prior,
    const bool* __restrict__ terminal, const float* __restrict__ tval,
    const bool* __restrict__ linked, const long long* __restrict__ action0,
    const long long* __restrict__ kid0, const bool* __restrict__ kid_term0,
    long long* __restrict__ leaf_parent, long long* __restrict__ action_out,
    long long* __restrict__ kid_out, int* iters, float c_puct, int nodes, int a_dim,
    int batch) {
  const int lane = threadIdx.x % WARP;
  const int env = blockIdx.x * WALK_ENVS_PER_BLOCK + threadIdx.x / WARP;
  if (env >= batch) return;  // the whole warp
  const long long row = (long long)env * nodes;
  long long node = 0, action = action0[env], kid = kid0[env];
  bool kid_term = kid_term0[env];
  int descents = 0;
  // a tree has fewer than ``nodes`` levels: the bound only stops a malformed one
  while (kid >= 0 && !kid_term && descents < nodes) {
    node = kid;
    const float sq = __fsqrt_rn((float)max(visit[row + node], 1));

    // unexpanded edges: the masked prior row (-1 = illegal or expanded)
    const float* up = uprior + (row + node) * a_dim;
    float bu = -INFINITY;
    int bu_a = INT_MAX;
    for (int a = lane; a < a_dim; a += WARP) {
      const float prior = up[a];
      const float sc = prior >= 0.0f ? __fmul_rn(__fmul_rn(c_puct, prior), sq) : -INFINITY;
      if (better(sc, a, bu, bu_a)) {
        bu = sc;
        bu_a = a;
      }
    }
    warp_best(bu, bu_a);

    // expanded edges, child-side over every slot; ties to the lowest slot
    float bc = -INFINITY;
    int c_star = INT_MAX;
    for (int c = lane; c < nodes; c += WARP) {
      float sc = -INFINITY;
      if (linked[row + c] && parent[row + c] == node) {
        const int v = visit[row + c];
        const float q = terminal[row + c] ? tval[row + c]
                                          : __fdiv_rn(-value_sum[row + c], (float)max(v, 1));
        const float u = __fdiv_rn(__fmul_rn(__fmul_rn(c_puct, e_prior[row + c]), sq),
                                  __fadd_rn(1.0f, (float)v));
        sc = __fadd_rn(q, u);
      }
      if (better(sc, c, bc, c_star)) {
        bc = sc;
        c_star = c;
      }
    }
    warp_best(bc, c_star);

    const long long bc_a = pa[row + c_star];
    const bool expanded_wins = bc > bu || (bc == bu && bc_a < bu_a);
    action = expanded_wins ? bc_a : (long long)bu_a;
    kid = expanded_wins ? (long long)c_star : -1;
    kid_term = expanded_wins && terminal[row + c_star];
    ++descents;
  }
  if (lane == 0) {
    leaf_parent[env] = node;
    action_out[env] = action;
    kid_out[env] = kid;
    if (iters != nullptr) atomicMax(iters, descents + 1);
  }
}

__global__ void __launch_bounds__(BACKUP_THREADS) backup_walk_kernel(
    int* visit, float* value_sum, const long long* __restrict__ parent,
    const long long* __restrict__ leaf, const float* __restrict__ value, int* lengths,
    int nodes, int batch) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= batch) return;
  const long long row = (long long)env * nodes;
  long long node = leaf[env];
  float v = value[env];
  int length = 0;
  while (node >= 0 && length < nodes) {
    visit[row + node] += 1;
    value_sum[row + node] = __fadd_rn(value_sum[row + node], v);
    node = parent[row + node];
    v = -v;
    ++length;
  }
  lengths[env] = length;
}

}  // namespace

extern "C" {

// Launch the selection walk on ``stream``; returns a CUDA error code (0 =
// ok).  Device pointers of the wrapper's tensors (layout above); ``iters``
// may be null.
int twixt_select_walk(const void* uprior, const void* visit, const void* value_sum,
                      const void* parent, const void* pa, const void* e_prior,
                      const void* terminal, const void* tval, const void* linked,
                      const void* action0, const void* kid0, const void* kid_term0,
                      void* leaf_parent, void* action_out, void* kid_out, void* iters,
                      float c_puct, int nodes, int a_dim, int batch, void* stream) {
  if (nodes < 1 || a_dim < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (batch + WALK_ENVS_PER_BLOCK - 1) / WALK_ENVS_PER_BLOCK;
  select_walk_kernel<<<blocks, WALK_ENVS_PER_BLOCK * WARP, 0, (cudaStream_t)stream>>>(
      (const float*)uprior, (const int*)visit, (const float*)value_sum,
      (const long long*)parent, (const long long*)pa, (const float*)e_prior,
      (const bool*)terminal, (const float*)tval, (const bool*)linked,
      (const long long*)action0, (const long long*)kid0, (const bool*)kid_term0,
      (long long*)leaf_parent, (long long*)action_out, (long long*)kid_out, (int*)iters,
      c_puct, nodes, a_dim, batch);
  return (int)cudaGetLastError();
}

// Launch the backup walk on ``stream`` (updates visit and value_sum in
// place); ``lengths`` int32 [B] receives each env's walk length.
int twixt_backup_walk(void* visit, void* value_sum, const void* parent, const void* leaf,
                      const void* value, void* lengths, int nodes, int batch, void* stream) {
  if (nodes < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (batch + BACKUP_THREADS - 1) / BACKUP_THREADS;
  backup_walk_kernel<<<blocks, BACKUP_THREADS, 0, (cudaStream_t)stream>>>(
      (int*)visit, (float*)value_sum, (const long long*)parent, (const long long*)leaf,
      (const float*)value, (int*)lengths, nodes, batch);
  return (int)cudaGetLastError();
}

const char* twixt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
