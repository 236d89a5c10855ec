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
// NI = 16, NV = 12, P = 64) one call reads about 1 MB and writes E*T*4
// bytes, and does a few hundred integer compares per pair, so its bound
// is about a microsecond, below the cost of a launch.  The design is
// therefore plain: a block takes kRowsPerBlock embedding rows, stages
// each row's phi, psi and gathered existing table in shared memory (they
// are read once per token of the row), and its threads walk the rows'
// (e, t) pairs flattened, so T = 33 does not leave a 128-wide block
// mostly idle and the [E,T] output is written coalesced.  Pairs whose
// result is already -1 (padded row, invalid token, failed phase gate)
// skip the remaining work.  No tensor cores and no TMA: there is no
// matrix product here.
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kThreads = 128;
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

__global__ void __launch_bounds__(kThreads)
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
                   int E, int G, int T, int NI, int NV, int NP, int P) {
  extern __shared__ int smem[];
  // per staged row: phi[NI] | psi[NV] | existing[P*5]
  const int row_words = NI + NV + 5 * P;
  const int e0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, E - e0);

  for (int i = threadIdx.x; i < rows * row_words; i += blockDim.x) {
    const int r = i / row_words;
    const int k = i - r * row_words;
    const int e = e0 + r;
    int v;
    if (k < NI) {
      v = phi[e * NI + k];
    } else if (k < NI + NV) {
      v = psi[e * NV + (k - NI)];
    } else {
      const int p = wrap_clamp(pid[e], NP);
      v = ex_stack[p * 5 * P + (k - NI - NV)];
    }
    smem[i] = v;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * T; i += blockDim.x) {
    const int r = i / T;
    const int t = i - r * T;
    const int e = e0 + r;
    int out = kInvalidSig;
    const int g = wrap_clamp(gid[e], G);
    const int* tok = tokens + (static_cast<long long>(g) * T + t) * 6;
    const int ty = tok[0];
    const int u1 = tok[1];
    const int u2 = tok[2];
    const int lab = tok[3];
    const int j = tok[4];
    const bool valid = tok[5] > 0;
    if (emb_valid[e] > 0 && valid) {
      const int p = wrap_clamp(pid[e], NP);
      const int nv = nv_stack[p];
      const int n_pat = npat_stack[p];
      const int mode = mode_stack[p];
      const int* s_phi = smem + r * row_words;
      const int* s_psi = s_phi + NI;
      const int* s_ex = s_psi + NV;

      // psi lookups: first (= minimum) matching column
      int pid1 = kBig, pid2 = kBig;
      for (int k = NV - 1; k >= 0; --k) {
        const int x = s_psi[k];
        if (x == u1) pid1 = k;
        if (x == u2) pid2 = k;
      }
      const bool m1 = pid1 < kBig;
      const bool m2 = pid2 < kBig;
      if (!m1) pid1 = nv;
      if (!m2) pid2 = nv;

      const bool is_v = ty <= 2;
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

      if (allowed) {
        // temporal slot: in-itemset position, else gap count
        int in_pos = kBig;
        int gap_idx = 0;
        for (int k = NI - 1; k >= 0; --k) {
          const int x = s_phi[k];
          if (x == j) in_pos = k;
          gap_idx += x < j;
        }
        const bool in_any = in_pos < kBig;
        const int in_idx = in_any ? in_pos : 0;
        const int slot_kind = in_any ? 0 : 1;
        const int slot_idx = in_any ? in_idx : gap_idx;
        const bool tail_ok =
            mode == kModeTail
                ? ((in_any && in_idx == n_pat - 1) ||
                   (!in_any && gap_idx == n_pat))
                : true;
        if (tail_ok) {
          // duplicate-TR-in-itemset rejection (only in-itemset slots)
          bool dup = false;
          if (in_any) {
            for (int k = 0; k < P && !dup; ++k) {
              const int* x = s_ex + 5 * k;
              dup = x[0] == slot_idx && x[1] == ty && x[2] == pu1 &&
                    x[3] == pu2 && x[4] == lab;
            }
          }
          if (!dup) {
            int v = slot_kind;
            v = shl_or(v, kSlBits, slot_idx);
            v = shl_or(v, kTyBits, ty);
            v = shl_or(v, kPuBits, pu1);
            v = shl_or(v, kPuBits, pu2);
            v = shl_or(v, kLabBits, lab + 1);
            out = v;
          }
        }
      }
    }
    sigs[static_cast<long long>(e) * T + t] = out;
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.  Launches on
// ``stream`` and returns cudaGetLastError() (0 when the launch was taken).
extern "C" int match_count_launch(
    const int* tokens, const int* gid, const int* phi, const int* psi,
    const int* emb_valid, const int* pid, const int* ex_stack,
    const int* nv_stack, const int* npat_stack, const int* mode_stack,
    int* sigs, int E, int G, int T, int NI, int NV, int NP, int P,
    cudaStream_t stream) {
  if (E <= 0 || T <= 0) return 0;
  const size_t smem =
      sizeof(int) * static_cast<size_t>(kRowsPerBlock) * (NI + NV + 5 * P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((E + kRowsPerBlock - 1) / kRowsPerBlock);
  match_count_kernel<<<grid, kThreads, smem, stream>>>(
      tokens, gid, phi, psi, emb_valid, pid, ex_stack, nv_stack, npat_stack,
      mode_stack, sigs, E, G, T, NI, NV, NP, P);
  return static_cast<int>(cudaGetLastError());
}
