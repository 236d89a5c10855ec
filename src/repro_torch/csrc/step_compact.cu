// step_compact: the compaction and frontier update of one embedding-join
// step of the serving path, one launch a step.
//
// Replaces no TPU kernel: on the TPU this is the epilogue of the join
// step that XLA fuses behind repro/kernels/containment/containment.py::
// contain_step_blocked.  Run eagerly on this card, the same code is 76-136
// small PyTorch launches a compacting step (a first-E extraction loop of
// 4 launches a slot, the decode, six gathers, the phi/psi update).  This
// kernel computes, bit for bit, the plain version
//   repro_torch/kernels/step_compact/ref.py::step_compact_core
// from contain_step's masks, in one launch.
//
// Inputs (contiguous unless a row stride is given):
//   bits [N,Ein,Tm] int32   tok_w [N,Tm,6] int32   phi [N,Ein,NI] int32
//   psi [N,Ein,NV] int32    valid [N,Ein] bytes     ct_sel [N] int32
//   step [N,>=8] int32, pu_c [N,2] int64, pu_ok [N,2] bytes: rows
//   `*_ld` elements apart, columns contiguous (views of the step table
//   and of _step_ranges' outputs, read in place)
// Outputs, compacting: phi_out [N,E,NI], psi_out [N,E,NV] int32,
//   valid_out [N,E] and ovf_out [N] bytes (torch.bool);
// terminal: acc_out [N], ovf_out [N] bytes.
//
// What bounds it on the card: latency and the launch, not bytes.  At the
// largest compacting call of a flat serving batch (N = 16384, Ein 4,
// Tm 8, emax 4, NI 3, NV 3) it moves 9.2 MB, 2.8 us at 3.35 TB/s, and a
// cell's work is a few dozen integer operations, but a chain of
// dependent steps: read the masks, rank the accepted candidates, then
// read the kept rows.  The plain version took 1.9-2.3 ms of host time a
// call at the serving shapes, the kernel 0.07-0.08 ms (PERF.md).
//
// Design, as trie_walk.cu's step for one slot: one warp per cell, 4 cells
// a block, no block barrier (a warp owns E ints of shared memory, the
// kept candidates, and __syncwarp orders its phases).
//  - Lanes over the cell's Ein*Tm masks (coalesced); candidate
//    c = (e*Tm + t)*2 + o.  Per group of 32 masks, __ballot_sync of the
//    two orientation bits; an accepted candidate's rank is the running
//    count plus __popc of the lower lanes' bits, the (row, token,
//    orientation) order exactly.  The walk stops once the count passes
//    E: the (E+1)-th candidate is the frontier overflow (a terminal
//    step without it stops at the first).
//  - Then lanes over the E*NI and E*NV output entries, coalesced.  A
//    kept slot r reads its source row sel[r] / (2 Tm) and window token;
//    a slot past the count copies row Ein - 1 with no update, where the
//    plain version's clamped candidate C - 1 points.
//  - The fresh-vertex tests read psi at pu_c where pu_ok (the plain
//    version's take_along_axis), and the update writes only the column
//    equal to the raw pu, as the plain version's one-hot does.
//  - The outputs are bytes, so the wrapper hands them out as torch.bool
//    with no cast after the kernel.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;  // cells a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCompact = 0, kTerminal = 1, kTerminalCount = 2;

struct Sizes {
  int N, Ein, Tm, NI, NV, E;
  long long step_ld, pu_c_ld, pu_ok_ld;
};

__global__ void __launch_bounds__(kWarp * kWarps)
step_compact_kernel(const int* __restrict__ bits,
                    const int* __restrict__ tok_w,
                    const int* __restrict__ phi, const int* __restrict__ psi,
                    const unsigned char* __restrict__ valid,
                    const int* __restrict__ step,
                    const int* __restrict__ ct_sel,
                    const long long* __restrict__ pu_c,
                    const unsigned char* __restrict__ pu_ok,
                    int* __restrict__ phi_out, int* __restrict__ psi_out,
                    unsigned char* __restrict__ valid_out,
                    unsigned char* __restrict__ acc_out,
                    unsigned char* __restrict__ ovf_out, Sizes z, int mode) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (i >= z.N) return;  // the whole warp: no block barrier follows
  const int Ein = z.Ein, Tm = z.Tm, NI = z.NI, NV = z.NV, E = z.E;
  extern __shared__ int smem[];
  int* const sel = smem + warp * E;

  // a truncated window may lose matches only if the frontier was live
  bool live = false;
  for (int e = lane; e < Ein; e += kWarp) live |= valid[i * Ein + e] != 0;
  const bool w_ovf = __any_sync(kFull, live) && __ldg(ct_sel + i) > Tm;

  // ---- first E accepted candidates by ballot, in candidate order
  const int P = Ein * Tm;
  const int* const b = bits + i * P;
  const unsigned lower = (1u << lane) - 1u;
  const int stop = mode == kTerminal ? 0 : E;  // decided past this count
  int cnt = 0;
  for (int base = 0; base < P && cnt <= stop; base += kWarp) {
    const int k = base + lane;
    const int v = k < P ? __ldg(b + k) : 0;
    const bool f0 = (v & 1) != 0, f1 = ((v >> 1) & 1) != 0;
    const unsigned b0 = __ballot_sync(kFull, f0);
    const unsigned b1 = __ballot_sync(kFull, f1);
    if (mode == kCompact) {
      int rank = cnt + __popc(b0 & lower) + __popc(b1 & lower);
      if (f0) {
        if (rank < E) sel[rank] = 2 * k;
        ++rank;
      }
      if (f1 && rank < E) sel[rank] = 2 * k + 1;
    }
    cnt += __popc(b0) + __popc(b1);
  }
  if (mode != kCompact) {
    if (lane == 0) {
      acc_out[i] = cnt > 0;
      ovf_out[i] = w_ovf || (mode == kTerminalCount && cnt > E);
    }
    return;
  }
  const int n_sel = cnt < E ? cnt : E;
  __syncwarp();

  // ---- the kept rows' phi / psi, lanes over the output entries
  const int* const st = step + i * z.step_ld;
  const int ty = __ldg(st), pu1 = __ldg(st + 1), pu2 = __ldg(st + 2);
  const int snew = __ldg(st + 4), idx = __ldg(st + 5);
  const bool is_v = ty <= 2;
  const long long* const pc = pu_c + i * z.pu_c_ld;
  const unsigned char* const pok = pu_ok + i * z.pu_ok_ld;
  const bool ok1 = pok[0] != 0, ok2 = pok[1] != 0;
  // pu_c is in range where pu_ok holds; clamped so that no read leaves
  // the row whatever it holds
  const long long c1 = pc[0] < 0 ? 0 : (pc[0] > NV - 1 ? NV - 1 : pc[0]);
  const long long c2 = pc[1] < 0 ? 0 : (pc[1] > NV - 1 ? NV - 1 : pc[1]);
  const int* const ph = phi + i * Ein * NI;
  const int* const ps = psi + i * Ein * NV;
  const int* const tw = tok_w + i * Tm * 6;
  int* const phi_o = phi_out + i * E * NI;
  int* const psi_o = psi_out + i * E * NV;
  const int last = Ein - 1;
  for (int q = lane; q < E * NI; q += kWarp) {
    const int r = q / NI, c = q - r * NI;
    int v;
    if (r < n_sel) {
      const int s = sel[r];
      const int e = s / (2 * Tm);
      v = __ldg(ph + e * NI + c);
      // the first TR of a new pattern itemset claims data itemset j
      if (c == idx && snew > 0) v = __ldg(tw + ((s >> 1) - e * Tm) * 6 + 4);
    } else {
      v = __ldg(ph + last * NI + c);
    }
    phi_o[q] = v;
  }
  for (int q = lane; q < E * NV; q += kWarp) {
    const int r = q / NV, c = q - r * NV;
    int v;
    if (r < n_sel) {
      const int s = sel[r];
      const int e = s / (2 * Tm);
      const int* const src = ps + e * NV;
      const int* const tok = tw + ((s >> 1) - e * Tm) * 6;
      const bool swap = (s & 1) != 0;
      const int u1 = __ldg(tok + 1), u2 = __ldg(tok + 2);
      v = __ldg(src + c);
      // fresh pattern vertices bind per the matched orientation
      if (c == pu1 && (!ok1 || __ldg(src + c1) < 0))
        v = (is_v || !swap) ? u1 : u2;
      if (c == pu2 && !is_v && (!ok2 || __ldg(src + c2) < 0))
        v = swap ? u1 : u2;
    } else {
      v = __ldg(ps + last * NV + c);
    }
    psi_o[q] = v;
  }
  for (int r = lane; r < E; r += kWarp) valid_out[i * E + r] = r < n_sel;
  if (lane == 0) ovf_out[i] = cnt > E || w_ovf;
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.  mode 0 compacts
// (phi_out, psi_out, valid_out, ovf_out), 1 is a terminal step (acc_out,
// ovf_out), 2 a terminal step that folds in the frontier overflow.
// Launches on ``stream`` and returns cudaGetLastError() (0 when the
// launch was taken), or cudaErrorInvalidValue when the kept candidates of
// a block's cells exceed 48 KB of shared memory.
extern "C" int step_compact_launch(
    const int* bits, const int* tok_w, const int* phi, const int* psi,
    const unsigned char* valid, const int* step, long long step_ld,
    const int* ct_sel, const long long* pu_c, long long pu_c_ld,
    const unsigned char* pu_ok, long long pu_ok_ld, int* phi_out,
    int* psi_out, unsigned char* valid_out, unsigned char* acc_out,
    unsigned char* ovf_out, int N, int Ein, int Tm, int NI, int NV, int E,
    int mode, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (Ein <= 0 || Tm <= 0 || E <= 0 || mode < kCompact ||
      mode > kTerminalCount)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 4LL * kWarps * E;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const Sizes z{N, Ein, Tm, NI, NV, E, step_ld, pu_c_ld, pu_ok_ld};
  const long long blocks = (N + kWarps - 1) / kWarps;
  step_compact_kernel<<<static_cast<unsigned>(blocks), kWarp * kWarps,
                        static_cast<size_t>(smem), stream>>>(
      bits, tok_w, phi, psi, valid, step, ct_sel, pu_c, pu_ok, phi_out,
      psi_out, valid_out, acc_out, ovf_out, z, mode);
  return static_cast<int>(cudaGetLastError());
}
