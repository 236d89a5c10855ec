// match_count: the embedding-join extension-signature scan of the miner.
//
// Replaces the TPU kernel
//   repro/kernels/match_count/match_count.py::match_signatures_blocked
// and computes, bit for bit, the plain version
//   repro_torch/kernels/match_count/ref.py::match_core
// in its per-row form: for every (embedding e, token t) the packed int32
// one-TR extension signature, or -1.
//
// Inputs (all int32, contiguous):
//   tokens [G,T,6]  gid [E]  phi [E,NI]  psi [E,NV]  emb_valid [E]
//   pid [E]  ex_stack [NP,P,5]  nv_stack, npat_stack, mode_stack [NP]
// Output: sigs [E,T].
// The kernel gathers tokens[gid[e]] and ex_stack[pid[e]] itself, so the
// [E,T,6] and [E,P,5] gathered copies never exist in device memory.
// Indices are wrapped and clamped into range as JAX's gather does; the
// miner's are always in range.
//
// What bounds it on the card: on the miner's chunks (E <= 1024, T = 33,
// NI = 16, NV = 12, P = 64) one call reads at most about 1 MB and writes
// E*T*4 bytes, and needs a few dozen integer operations per pair, so its
// bound is a third of a microsecond, below the cost of a launch.  What
// is left is the launch, one wave of blocks, and the chain of dependent
// loads in front of each block's one barrier (gid -> tokens,
// pid -> ex_stack).  The design keeps that chain short and gives every
// thread one pass:
//   - a block takes R whole rows, R = 128 / T (at most 32, at least 1),
//     and one thread per (row, token) pair, t fastest, so the [E,T]
//     output is written coalesced and no thread takes a second pair
//     (only a row of more than 256 tokens loops, one row a block);
//   - each thread loads its token before the barrier, beside the
//     staging, so the two chains of dependent loads overlap;
//   - a row's phi and psi are staged once (the block's rows are
//     contiguous in memory: a plain copy, no division);
//   - warp w stages rows w, w + warps, ...: each row's scalars (valid,
//     nv, n_pat, mode) and its pattern's existing-TR table, compacted by
//     ballot to the rows whose itemset field is >= 0, in their order,
//     with a count.  A duplicate needs an in-itemset slot, which is
//     >= 0, so the other rows can never match; the check loops over the
//     count (at most 6 on the miner's path, not P = 64) and still
//     compares all five fields.
// Every size is taken at run time; one copy of the kernel serves every
// width.  No tensor cores, no TMA and no cp.async: there is no matrix
// product, and one call's inputs are about 1 MB.  Measured on the card
// and not kept: 256 or 64 threads a block in place of 128, a first
// version with blocks of up to 1024 threads (its build spilled
// registers), a copy with the miner's widths fixed (unrolled scans over
// int4 reads), and staging each run of equal pattern ids once a block
// in place of once a row.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kTargetThreads = 128;  // R * T aims at this many threads
constexpr int kMaxRows = 32;         // bounds a block's shared memory
constexpr int kMaxThreads = 256;     // a longer row loops
constexpr int kMaxSmem = 227 * 1024;  // bytes a block may have on sm_90
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 0x3FFFFFF;
constexpr int kSentV = 15;
constexpr int kInvalidSig = -1;
constexpr int kLabBits = 14;
constexpr int kPuBits = 4;
constexpr int kTyBits = 3;
constexpr int kSlBits = 5;
constexpr int kModeRoot = 0;
constexpr int kModeVertexPhase = 1;
constexpr int kModeEdgePhase = 2;
constexpr int kModeTail = 3;

__device__ __forceinline__ int wrap_clamp(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// int32 shift-or with two's-complement wrap, as the reference's int32
// shifts do (a signed left shift that overflows is undefined in C++).
__device__ __forceinline__ int shl_or(int v, int bits, int x) {
  return static_cast<int>((static_cast<unsigned>(v) << bits) |
                          static_cast<unsigned>(x));
}

struct Token {
  int ty, u1, u2, lab, j, valid;
};

__device__ __forceinline__ Token load_token(const int* __restrict__ tokens,
                                            int g, int T, int t) {
  const int* x = tokens + (static_cast<long long>(g) * T + t) * 6;
  return {__ldg(x), __ldg(x + 1), __ldg(x + 2), __ldg(x + 3), __ldg(x + 4),
          __ldg(x + 5)};
}

// One warp copies pattern p's rows whose itemset field is >= 0 into
// ``tab`` ([n,5], in their order) and returns n (in every lane).
__device__ __forceinline__ int stage_table(const int* __restrict__ ex_stack,
                                           int p, int P, int* tab,
                                           int lane) {
  const int* src = ex_stack + static_cast<long long>(p) * P * 5;
  int n = 0;
  for (int k0 = 0; k0 < P; k0 += 32) {
    const int* x = src + 5 * (k0 + lane);
    const bool in = k0 + lane < P;
    const int f0 = in ? __ldg(x) : -1;
    const int f1 = in ? __ldg(x + 1) : 0;
    const int f2 = in ? __ldg(x + 2) : 0;
    const int f3 = in ? __ldg(x + 3) : 0;
    const int f4 = in ? __ldg(x + 4) : 0;
    const bool real = f0 >= 0;
    const unsigned m = __ballot_sync(kFull, real);
    if (real) {
      int* dst = tab + 5 * (n + __popc(m & ((1u << lane) - 1u)));
      dst[0] = f0;
      dst[1] = f1;
      dst[2] = f2;
      dst[3] = f3;
      dst[4] = f4;
    }
    n += __popc(m);
  }
  return n;
}

// The signature of one (row, token) pair, or -1, from the row's staged
// phi [NI], psi [NV], scalars and compacted table [n_tab,5].
__device__ __forceinline__ int signature(const Token& tk,
                                         const int* s_phi_r,
                                         const int* s_psi_r, int NI,
                                         int NV, int nv, int n_pat,
                                         int mode, const int* tab,
                                         int n_tab) {
  // psi lookups: first (= minimum) matching column
  int pid1 = kBig, pid2 = kBig;
  for (int k = NV - 1; k >= 0; --k) {
    const int x = s_psi_r[k];
    if (x == tk.u1) pid1 = k;
    if (x == tk.u2) pid2 = k;
  }
  const bool m1 = pid1 < kBig;
  const bool m2 = pid2 < kBig;
  if (!m1) pid1 = nv;
  if (!m2) pid2 = nv;

  const bool is_v = tk.ty <= 2;
  bool allowed;
  int pu1, pu2;
  if (is_v) {
    allowed = mode == kModeRoot || mode == kModeTail || m1;
    pu1 = pid1;
    pu2 = kSentV;
  } else {
    const bool both = m1 && m2;
    const bool one = m1 != m2;
    const int mapped = m1 ? pid1 : pid2;
    pu1 = both ? min(pid1, pid2) : (one ? mapped : nv);
    pu2 = both ? max(pid1, pid2) : (one ? nv : nv + 1);
    allowed = mode == kModeVertexPhase
                  ? false
                  : (mode == kModeEdgePhase ? (m1 || m2) : true);
  }
  if (!allowed) return kInvalidSig;

  // temporal slot: in-itemset position, else gap count
  int in_pos = kBig;
  int gap_idx = 0;
  for (int k = NI - 1; k >= 0; --k) {
    const int x = s_phi_r[k];
    if (x == tk.j) in_pos = k;
    gap_idx += x < tk.j;
  }
  const bool in_any = in_pos < kBig;
  const int in_idx = in_any ? in_pos : 0;
  const int slot_kind = in_any ? 0 : 1;
  const int slot_idx = in_any ? in_idx : gap_idx;
  const bool tail_ok = mode == kModeTail
                           ? ((in_any && in_idx == n_pat - 1) ||
                              (!in_any && gap_idx == n_pat))
                           : true;
  if (!tail_ok) return kInvalidSig;

  // duplicate-TR-in-itemset rejection (only in-itemset slots, whose
  // slot_idx is >= 0: the staged rows are all that can match)
  if (in_any) {
    for (int k = 0; k < n_tab; ++k) {
      const int* x = tab + 5 * k;
      if (x[0] == slot_idx && x[1] == tk.ty && x[2] == pu1 &&
          x[3] == pu2 && x[4] == tk.lab)
        return kInvalidSig;
    }
  }
  int v = slot_kind;
  v = shl_or(v, kSlBits, slot_idx);
  v = shl_or(v, kTyBits, tk.ty);
  v = shl_or(v, kPuBits, pu1);
  v = shl_or(v, kPuBits, pu2);
  v = shl_or(v, kLabBits, tk.lab + 1);
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
match_count_kernel(const int* __restrict__ tokens,
                   const int* __restrict__ gid,
                   const int* __restrict__ phi,
                   const int* __restrict__ psi,
                   const int* __restrict__ emb_valid,
                   const int* __restrict__ pid,
                   const int* __restrict__ ex_stack,
                   const int* __restrict__ nv_stack,
                   const int* __restrict__ npat_stack,
                   const int* __restrict__ mode_stack,
                   int* __restrict__ sigs,
                   int E, int G, int T, int NI, int NV, int NP, int P,
                   int R) {
  // shared: phi [R,NI] | psi [R,NV] | row scalars [R,5] (valid, nv,
  // n_pat, mode, table rows) | tables [R,P,5]
  extern __shared__ int smem[];
  int* s_phi = smem;
  int* s_psi = s_phi + R * NI;
  int* s_scal = s_psi + R * NV;
  int* s_tab = s_scal + R * 5;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long e0 = static_cast<long long>(blockIdx.x) * R;
  const int rows = static_cast<int>(min(static_cast<long long>(R), E - e0));

  // this thread's first pair, and its token, loaded ahead of the barrier
  const int r = tid / T;
  int t = tid - r * T;
  const bool live = r < rows;
  Token tk{};
  int g = 0;
  if (live) {
    g = wrap_clamp(__ldg(gid + e0 + r), G);
    tk = load_token(tokens, g, T, t);
  }

  // the block's rows are contiguous: phi and psi copy as flat ranges
  for (int i = tid; i < rows * NI; i += blockDim.x)
    s_phi[i] = __ldg(phi + e0 * NI + i);
  for (int i = tid; i < rows * NV; i += blockDim.x)
    s_psi[i] = __ldg(psi + e0 * NV + i);

  // warp w stages rows w, w + warps, ...: scalars and compacted table
  const int n_warps = blockDim.x >> 5;
  for (int rr = warp; rr < rows; rr += n_warps) {
    const int p = wrap_clamp(__ldg(pid + e0 + rr), NP);
    int* sc = s_scal + 5 * rr;
    if (lane == 0) {
      sc[0] = __ldg(emb_valid + e0 + rr);
      sc[1] = __ldg(nv_stack + p);
      sc[2] = __ldg(npat_stack + p);
      sc[3] = __ldg(mode_stack + p);
    }
    const int n = stage_table(ex_stack, p, P, s_tab + rr * P * 5, lane);
    if (lane == 0) sc[4] = n;
  }
  __syncthreads();
  if (!live) return;

  const int* sc = s_scal + 5 * r;
  const bool row_valid = sc[0] > 0;
  int* out_row = sigs + (e0 + r) * T;
  for (;;) {
    out_row[t] = row_valid && tk.valid > 0
                     ? signature(tk, s_phi + r * NI, s_psi + r * NV, NI, NV,
                                 sc[1], sc[2], sc[3], s_tab + r * P * 5,
                                 sc[4])
                     : kInvalidSig;
    // a second pass only when one row's T exceeds the block
    t += blockDim.x;
    if (t >= T) break;
    tk = load_token(tokens, g, T, t);
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.  Launches on
// ``stream`` and returns cudaGetLastError() (0 when the launch was taken;
// cudaErrorInvalidValue when one row's tables exceed a block's shared
// memory).
extern "C" int match_count_launch(
    const int* tokens, const int* gid, const int* phi, const int* psi,
    const int* emb_valid, const int* pid, const int* ex_stack,
    const int* nv_stack, const int* npat_stack, const int* mode_stack,
    int* sigs, int E, int G, int T, int NI, int NV, int NP, int P,
    cudaStream_t stream) {
  if (E <= 0 || T <= 0) return 0;
  // words a row takes in shared memory (see the kernel's layout)
  const size_t row_words =
      static_cast<size_t>(NI) + NV + 5 + 5 * static_cast<size_t>(P);
  const int max_rows =
      static_cast<int>(kMaxSmem / (sizeof(int) * row_words));
  if (max_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int R = std::min({T >= kTargetThreads ? 1 : kTargetThreads / T,
                          kMaxRows, max_rows, E});
  const int threads = static_cast<int>(
      std::min<long long>(kMaxThreads, (1LL * R * T + 31) / 32 * 32));
  const size_t smem = sizeof(int) * R * row_words;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((E + R - 1) / R);
  match_count_kernel<<<grid, threads, smem, stream>>>(
      tokens, gid, phi, psi, emb_valid, pid, ex_stack, nv_stack, npat_stack,
      mode_stack, sigs, E, G, T, NI, NV, NP, P, R);
  return static_cast<int>(cudaGetLastError());
}
