// The batched search's two walks, for Hopper: the lockstep PUCT selection
// (S1b, select_walk), from a root entry or from the root itself, and the
// parent-chain backup (S1c, backup_walk).
//
// Not TPU kernels: the JAX search runs both walks as lax.while_loops inside
// its jitted simulation (twixt_for_open_spiel_tpu/models/mcts.py:368 with
// _best_edge at :244, the PUCT root entry at :672, and :511), which XLA
// fuses.  The port ran them as host loops of torch ops with one host read
// an iteration; an H100 profile of the search named the reads (PERF.md §5),
// so each walk is one launch here and a simulation reads nothing back.
//
// Semantics: ops/search_walk.py::select_walk_reference and
// backup_walk_reference (the plain torch versions), bit for bit.
//
// Layout: the search tree's arrays, env leading, contiguous:
//   uprior f32 [B, nodes, A]; visit i32, value_sum f32, parent i64, pa i64,
//   e_prior f32, terminal bool, tval f32, linked bool [B, nodes].
//
// select_walk.  One warp an env.  The warp first stages its env's slot rows
// into shared memory, lanes over the slots (each field's row is read once,
// 32 consecutive slots a load): per slot the visit count, the action into
// it, the terminal flag, its key (the parent slot where the slot is linked,
// else -1, which no node equals), and the child-side terms that do not
// depend on the parent: q = -value_sum/max(visit,1) (tval on a terminal
// child), c_puct*e_prior and 1+visit; 25 bytes a slot.  Then the walk: with
// a null action0 every env starts with the best edge at slot 0 (the PUCT
// root entry); else from the given entry (action, kid, kid_term).  While
// the chosen child exists and is not terminal, step into it and score its
// edges.  The unexpanded edges are the masked-prior row, the level's only
// read of device memory (lanes over the A actions, coalesced, issued
// before the children are scored so that the load runs under that pass,
// and for the first level before the staging, under its loads);
// the expanded ones are scored child-side from shared memory (lanes over
// the slots whose key is the node).  Each pass ends in a shuffle reduction
// that keeps torch's argmax: the first of equal maxima, NaN above
// everything, which is an order of (value, slot) pairs, so the lanes' order
// does not matter.  The scores keep the plain version's float order with no
// contraction (__fmul_rn, __fdiv_rn, __fadd_rn, __fsqrt_rn): sc_u =
// (c_puct*up)*sq, u = ((c_puct*e_prior)*sq)/(1+visit), q+u; a tie between
// an expanded and an unexpanded edge goes to the lower action.  Each env
// adds 1 + its descents below the entry, the plain loop's iteration count,
// to a per-simulation maximum (``iters``, may be null).
//
// backup_walk.  One warp an env.  Lanes stage the env's parent row into
// shared memory, lane 0 follows the chain from the leaf to the root there
// and records the path, then lanes add in parallel: node i of the path
// (the leaf is 0) gets a visit and value_sum += (i odd ? -v : v), one float
// add a node as in the plain loop.  The plain loop runs until the longest
// walk ends (at least once) and adds +0.0 at slot 0 of every env whose walk
// ended earlier (a -0.0 sum becomes +0.0).  The kernel does the same
// itself: each env writes its walk's length and raises a device-wide
// maximum in ``scratch``; each block, after __threadfence(), takes a ticket
// there, and the last block to finish adds the +0.0s, raises ``iters`` to
// the longest walk and zeroes the maximum and the ticket for the next
// launch.  scratch is int32 [2 + B] (maximum, ticket, lengths), zeroed
// before its first launch.  Streams: launches that share a scratch must
// not overlap, so each stream has its own (the wrapper keeps one per device
// and stream); a launch that faults leaves the counters set, but a fault
// loses the CUDA context too.
//
// What bounds them on this card: at the search's shapes (board 12, B=512,
// 65 slots) a walk needs a 576-byte prior row a level and about 1.7 KB of
// slot rows an env, and a backup a few dozen bytes an env: far under a
// microsecond of HBM time.  Both are chains of dependent steps, so latency
// bounds them.  The design leaves one device-memory round trip a level,
// the first under the staging's (S1b), or five in all (S1c: the parent
// row, the path's adds, the fence and the ticket, the last block's loads),
// and the launch.  Measured on an H100 80GB HBM3 at 700 W (PERF.md §6,
// simulation 32 of a config-5 search, a walk of three levels): an empty
// kernel of the walks' launch shape takes 1.8-2.0 µs of device time a
// launch (4.2-6.3 µs back to back from the host), S1b 6.7-6.9 µs from the
// root (5.8-5.9 below a given entry) and S1c 6.5-7.2 µs; the wrappers'
// host time, 17-77 µs a call, sets the pace of launches back to back.
//
// Shared memory: the launchers size a block from select_env_bytes and
// backup_env_bytes beside the kernel's static bytes, opt in above 48 KB,
// and return TOO_MANY_SLOTS where one env exceeds the device's most (on
// Hopper 9,298 slots for S1b, 29,057 for S1c), which the wrapper raises.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ops/_cuda.py).  Plain C entry points, bound with
// ctypes; no PyTorch headers.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_ENVS_PER_BLOCK = 4;  // warps
// the shared memory a block gets without opting in
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int PRIOR_UNROLL = 8;  // prior-row loads a lane keeps in flight
// the launchers' code for a ``nodes`` at which one env's staged rows do not
// fit a block's shared memory (ops/search_walk.py raises its own error for it)
constexpr int TOO_MANY_SLOTS = -1;

// Shared bytes an env: select_walk's six 4-byte rows and its 1-byte row
// (rounded to 16), backup_walk's parent row and path.
__host__ __device__ constexpr int select_env_bytes(int nodes) {
  return 24 * nodes + (nodes + 15) / 16 * 16;
}
__host__ __device__ constexpr int backup_env_bytes(int nodes) { return 8 * nodes; }

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

// An env's staged slot rows (select_walk).
struct Slots {
  float* q;     // the child's value for its parent
  float* cpe;   // c_puct * e_prior
  float* den;   // 1 + visit
  int* key;     // parent slot if linked, else -1
  int* visit;
  int* pa;      // the action into the slot
  unsigned char* term;

  __device__ Slots(unsigned char* base, int nodes)
      : q((float*)base), cpe(q + nodes), den(cpe + nodes), key((int*)(den + nodes)),
        visit(key + nodes), pa(visit + nodes), term((unsigned char*)(pa + nodes)) {}
};

__device__ __forceinline__ void load_priors(float (&p)[PRIOR_UNROLL], const float* up, int base,
                                            int a_dim, int lane) {
#pragma unroll
  for (int k = 0; k < PRIOR_UNROLL; ++k) {
    const int a = base + k * WARP + lane;
    p[k] = a < a_dim ? up[a] : -1.0f;
  }
}

// The best PUCT edge at ``node`` (every lane gets it): (action, kid,
// kid_term), kid -1 when the best edge is unexpanded.  ``p`` holds the
// first loads of the node's prior row ``up``, issued by the caller: they
// are in flight while the children are scored.
__device__ __forceinline__ void best_edge(const Slots& s, const float* __restrict__ up,
                                          float (&p)[PRIOR_UNROLL], int node, float c_puct,
                                          int nodes, int a_dim, int lane, long long& action,
                                          long long& kid, bool& kid_term) {
  const float sq = __fsqrt_rn((float)max(s.visit[node], 1));

  // expanded edges, child-side from shared memory; ties to the lowest slot
  float bc = -INFINITY;
  int c_star = INT_MAX;
  for (int c = lane; c < nodes; c += WARP) {
    const float sc = s.key[c] == node
                         ? __fadd_rn(s.q[c], __fdiv_rn(__fmul_rn(s.cpe[c], sq), s.den[c]))
                         : -INFINITY;
    if (better(sc, c, bc, c_star)) {
      bc = sc;
      c_star = c;
    }
  }
  warp_best(bc, c_star);

  // unexpanded edges: the masked prior row (-1 = illegal or expanded)
  float bu = -INFINITY;
  int bu_a = INT_MAX;
  for (int base = 0;;) {
#pragma unroll
    for (int k = 0; k < PRIOR_UNROLL; ++k) {
      const int a = base + k * WARP + lane;
      const float sc = p[k] >= 0.0f ? __fmul_rn(__fmul_rn(c_puct, p[k]), sq) : -INFINITY;
      if (a < a_dim && better(sc, a, bu, bu_a)) {
        bu = sc;
        bu_a = a;
      }
    }
    base += PRIOR_UNROLL * WARP;
    if (base >= a_dim) break;
    load_priors(p, up, base, a_dim, lane);
  }
  warp_best(bu, bu_a);

  const long long bc_a = s.pa[c_star];
  const bool expanded_wins = bc > bu || (bc == bu && bc_a < bu_a);
  action = expanded_wins ? bc_a : (long long)bu_a;
  kid = expanded_wins ? (long long)c_star : -1;
  kid_term = expanded_wins && s.term[c_star];
}

__global__ void __launch_bounds__(MAX_ENVS_PER_BLOCK * WARP) select_walk_kernel(
    const float* __restrict__ uprior, const int* __restrict__ visit,
    const float* __restrict__ value_sum, const long long* __restrict__ parent,
    const long long* __restrict__ pa, const float* __restrict__ e_prior,
    const bool* __restrict__ terminal, const float* __restrict__ tval,
    const bool* __restrict__ linked, const long long* __restrict__ action0,
    const long long* __restrict__ kid0, const bool* __restrict__ kid_term0,
    long long* __restrict__ leaf_parent, long long* __restrict__ action_out,
    long long* __restrict__ kid_out, int* iters, float c_puct, int nodes, int a_dim,
    int batch, int envs_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const int env = blockIdx.x * envs_per_block + warp;
  if (env >= batch) return;  // the whole warp; no block barrier follows
  const long long row = (long long)env * nodes;
  const Slots s(smem + warp * select_env_bytes(nodes), nodes);

  long long action = -1, kid = -1;
  bool kid_term = false;
  if (action0 != nullptr) {
    action = action0[env];
    kid = kid0[env];
    kid_term = kid_term0[env];
  }
  // the first level's node is known before the staging (the root, or the
  // entry's child when the walk descends into it): its prior row's loads
  // go out first and overlap the staging's
  const bool from_root = action0 == nullptr;
  const bool descends = kid >= 0 && kid < nodes && !kid_term;
  float p[PRIOR_UNROLL];
  bool loaded = from_root || descends;
  if (loaded) load_priors(p, uprior + (row + (from_root ? 0 : kid)) * a_dim, 0, a_dim, lane);
#pragma unroll 4
  for (int c = lane; c < nodes; c += WARP) {
    const long long g = row + c;
    const int v = visit[g];
    const float vs = value_sum[g];
    const long long p = parent[g];
    const long long a = pa[g];
    const float ep = e_prior[g];
    const bool t = terminal[g];
    const float tv = tval[g];
    const bool l = linked[g];
    s.q[c] = t ? tv : __fdiv_rn(-vs, (float)max(v, 1));
    s.cpe[c] = __fmul_rn(c_puct, ep);
    s.den[c] = __fadd_rn(1.0f, (float)v);
    s.key[c] = l && p >= 0 && p < nodes ? (int)p : -1;
    s.visit[c] = v;
    s.pa[c] = (int)a;
    s.term[c] = t;
  }
  __syncwarp();

  long long node = 0;
  if (from_root) {
    best_edge(s, uprior + row * a_dim, p, 0, c_puct, nodes, a_dim, lane, action, kid, kid_term);
    loaded = false;
  }
  int descents = 0;
  // a tree has fewer than ``nodes`` levels: the bounds only stop a malformed one
  while (kid >= 0 && kid < nodes && !kid_term && descents < nodes) {
    node = kid;
    const float* up = uprior + (row + node) * a_dim;
    if (!loaded) load_priors(p, up, 0, a_dim, lane);
    loaded = false;
    best_edge(s, up, p, (int)node, c_puct, nodes, a_dim, lane, action, kid, kid_term);
    ++descents;
  }
  if (lane == 0) {
    leaf_parent[env] = node;
    action_out[env] = action;
    kid_out[env] = kid;
    if (iters != nullptr) atomicMax(iters, descents + 1);
  }
}

__global__ void __launch_bounds__(MAX_ENVS_PER_BLOCK * WARP) backup_walk_kernel(
    int* visit, float* value_sum, const long long* __restrict__ parent,
    const long long* __restrict__ leaf, const float* __restrict__ value, int* scratch,
    int* iters, int nodes, int batch, int envs_per_block) {
  extern __shared__ int chains[];
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const int env = blockIdx.x * envs_per_block + warp;
  if (env < batch) {
    const long long row = (long long)env * nodes;
    int* par = chains + warp * 2 * nodes;
    int* path = par + nodes;
    const long long start = leaf[env];
    const float v = value[env];
    for (int c = lane; c < nodes; c += WARP) {
      const long long p = parent[row + c];
      par[c] = p >= 0 && p < nodes ? (int)p : -1;
    }
    __syncwarp();
    int length = 0;
    if (lane == 0) {
      int node = start >= 0 && start < nodes ? (int)start : -1;
      while (node >= 0 && length < nodes) {
        path[length++] = node;
        node = par[node];
      }
    }
    length = __shfl_sync(FULL, length, 0);
    __syncwarp();
    for (int i = lane; i < length; i += WARP) {
      const long long g = row + path[i];
      visit[g] += 1;
      value_sum[g] = __fadd_rn(value_sum[g], (i & 1) ? -v : v);
    }
    if (lane == 0) {
      scratch[2 + env] = length;
      atomicMax(scratch, length);
    }
  }

  // the last block to finish: the plain loop's trailing +0.0s and its count
  __threadfence();
  __syncthreads();
  int ticket_last = 0;
  if (threadIdx.x == 0) ticket_last = atomicAdd(scratch + 1, 1) == (int)gridDim.x - 1;
  if (!__syncthreads_or(ticket_last)) return;  // a barrier that hands thread 0's answer to all
  __threadfence();
  const int longest = max(1, __ldcg(scratch));
  for (int e = threadIdx.x; e < batch; e += blockDim.x) {
    float* root = value_sum + (long long)e * nodes;
    const float sum = __ldcg(root);  // loaded beside the length: one round trip
    if (__ldcg(scratch + 2 + e) < longest) __stcg(root, __fadd_rn(sum, 0.0f));
  }
  if (threadIdx.x == 0) {
    if (iters != nullptr) atomicMax(iters, longest);
    scratch[0] = 0;
    scratch[1] = 0;
  }
}

__global__ void empty_kernel() {}

// A kernel's static shared bytes (neither walk declares any), -1 when
// the runtime cannot say; each launcher asks once.
template <typename Kernel>
int static_smem(Kernel kernel) {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? (int)attr.sharedSizeBytes : -1;
}

// Envs a block and dynamic shared bytes a block for ``env_bytes`` an env,
// beside the kernel's ``fixed`` static bytes: up to 4 envs within the 48 KB
// a block gets without opting in, else one env opted in up to the device's
// most (227 KB on Hopper); TOO_MANY_SLOTS when one env does not fit.
template <typename Kernel>
int launch_shape(Kernel kernel, int fixed, int env_bytes, int batch, int* envs, int* bytes) {
  if (fixed < 0) return (int)cudaErrorInvalidDeviceFunction;
  *envs = std::max(1, std::min({MAX_ENVS_PER_BLOCK, batch, (SMEM_DEFAULT - fixed) / env_bytes}));
  *bytes = *envs * env_bytes;
  if (*bytes + fixed <= SMEM_DEFAULT) return 0;
  int device = 0, most = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (*bytes + fixed > most) return TOO_MANY_SLOTS;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
}

}  // namespace

extern "C" {

// Launch the selection walk on ``stream``; returns a CUDA error code (0 =
// ok).  Device pointers of the wrapper's tensors (layout above); a null
// ``action0`` (kid0 and kid_term0 null too) starts every env at the root's
// best edge; ``iters`` may be null.
int twixt_select_walk(const void* uprior, const void* visit, const void* value_sum,
                      const void* parent, const void* pa, const void* e_prior,
                      const void* terminal, const void* tval, const void* linked,
                      const void* action0, const void* kid0, const void* kid_term0,
                      void* leaf_parent, void* action_out, void* kid_out, void* iters,
                      float c_puct, int nodes, int a_dim, int batch, void* stream) {
  if (nodes < 1 || a_dim < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  int envs = 0, bytes = 0;
  static const int fixed = static_smem(select_walk_kernel);
  const int rc =
      launch_shape(select_walk_kernel, fixed, select_env_bytes(nodes), batch, &envs, &bytes);
  if (rc != 0) return rc;
  select_walk_kernel<<<(batch + envs - 1) / envs, envs * WARP, bytes, (cudaStream_t)stream>>>(
      (const float*)uprior, (const int*)visit, (const float*)value_sum,
      (const long long*)parent, (const long long*)pa, (const float*)e_prior,
      (const bool*)terminal, (const float*)tval, (const bool*)linked,
      (const long long*)action0, (const long long*)kid0, (const bool*)kid_term0,
      (long long*)leaf_parent, (long long*)action_out, (long long*)kid_out, (int*)iters,
      c_puct, nodes, a_dim, batch, envs);
  return (int)cudaGetLastError();
}

// Launch the backup walk on ``stream``: updates visit and value_sum in
// place, the trailing +0.0s included, and raises ``iters`` (may be null) to
// the longest walk.  ``scratch`` int32 [2 + batch], its first two words 0.
int twixt_backup_walk(void* visit, void* value_sum, const void* parent, const void* leaf,
                      const void* value, void* scratch, void* iters, int nodes, int batch,
                      void* stream) {
  if (nodes < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  int envs = 0, bytes = 0;
  static const int fixed = static_smem(backup_walk_kernel);
  const int rc =
      launch_shape(backup_walk_kernel, fixed, backup_env_bytes(nodes), batch, &envs, &bytes);
  if (rc != 0) return rc;
  backup_walk_kernel<<<(batch + envs - 1) / envs, envs * WARP, bytes, (cudaStream_t)stream>>>(
      (int*)visit, (float*)value_sum, (const long long*)parent, (const long long*)leaf,
      (const float*)value, (int*)scratch, (int*)iters, nodes, batch, envs);
  return (int)cudaGetLastError();
}

// Launch an empty kernel of ``blocks`` x ``threads`` on ``stream``: the
// launch floor the walks are timed beside.
int twixt_search_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* twixt_cuda_error_string(int code) {
  if (code == TOO_MANY_SLOTS) return "one env's slot rows do not fit a block's shared memory";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
