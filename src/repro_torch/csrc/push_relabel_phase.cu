// Kernel B: one push/relabel compute phase of the unfused engine.
//
// Replaces the TPU kernel repro/kernels/push_relabel.py::push_relabel_phase
// (body _pr_kernel, pl.pallas_call at push_relabel.py:171), which tiles one
// region's rows into VMEM blocks of 256 and keeps the region's labels
// resident for the neighbour gather.
//
// What it computes, per row u of the [K*V] batch (k = u / V):
//   nlab[e]  = pushable ? (intra ? lab[k, nbr[e]] : cross_lab[e]) : INF
//   act      = excess > 0 && lab < d_inf[k]
//   adm[e]   = cf[e] > 0 && lab == nlab[e] + 1 && act
//   delta    = clip(avail - exclusive_cumsum(caps), 0, caps) over
//              caps = [sink cap if sink-admissible, cf[e] if adm[e]]
//   new_lab  = act && no admissible arc ? max(min(1 + min residual nlab,
//              d_inf), lab) : lab
// mode 0 writes both outputs, 1 only delta ("push"), 2 only new_lab
// ("relabel"); the scatter of the deltas stays outside, in torch.
//
// What bounds it on the H100: bytes.  A row reads 5 int32 [E] arrays and 3
// scalars and writes E+1 (or 1) words, a few integer operations per word:
// far below the 67 T ops/s of the CUDA cores at 3.35 TB/s.  The label
// gather lab[k, nbr] is the only non-streaming access; a region's labels
// (64 KiB at V = 16384) stay in L2.
//
// What the design does about it: one thread per row, rows of neighbouring
// threads adjacent, so the [V] vectors load coalesced; each [E] row is a
// short sequential loop (E is 4-16) of 4-byte loads, and the dropped output
// of a mode is never written.  Row-major [V, E] makes the per-thread row
// loads strided by E words; a transposed or vectorised layout is later work.

#include "common.cuh"

template <int MODE>
__global__ void pr_phase_kernel(
    const int* __restrict__ lab, const int* __restrict__ cf,
    const int* __restrict__ sink_cf, const int* __restrict__ excess,
    const int* __restrict__ nbr, const int* __restrict__ intra,
    const int* __restrict__ pushable, const int* __restrict__ cross_lab,
    const int* __restrict__ d_inf, int* __restrict__ delta,
    int* __restrict__ new_lab, int K, int V, int E) {
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= (long long)K * V) return;
  const long long k = row / V;
  const int* lab_k = lab + k * V;
  const int dinf = d_inf[k];
  const int my = lab[row];
  const int ex = excess[row];
  const int sk = sink_cf[row];
  const bool act = ex > 0 && my < dinf;
  const bool sink_adm = sk > 0 && my == 1 && act;
  const int avail = act ? ex : 0;
  const long long b = row * E;
  int* drow = MODE != 2 ? delta + row * (E + 1) : nullptr;

  int cum = sink_adm ? sk : 0;      // exclusive prefix sum after column 0
  if (MODE != 2) drow[0] = min(max(avail, 0), cum);
  bool any_adm = false;
  int cand = INT_MAX;
  for (int e = 0; e < E; ++e) {
    const int c = cf[b + e];
    int nl = intra[b + e] ? lab_k[nbr[b + e]] : cross_lab[b + e];
    if (!pushable[b + e]) nl = PR_INF_LABEL;
    const bool adm = c > 0 && my == nl + 1 && act;
    if (MODE != 2) {
      const int cap = adm ? c : 0;
      drow[1 + e] = min(max(avail - cum, 0), cap);
      cum += cap;
    }
    if (MODE != 1) {
      any_adm |= adm;
      cand = min(cand, c > 0 ? nl + 1 : PR_INF_LABEL);
    }
  }
  if (MODE != 1) {
    if (sk > 0) cand = min(cand, 1);
    const bool no_adm = act && !any_adm && !sink_adm;
    new_lab[row] = no_adm ? max(min(cand, dinf), my) : my;
  }
}

extern "C" int pr_phase_i32(const int* lab, const int* cf, const int* sink_cf,
                            const int* excess, const int* nbr,
                            const int* intra, const int* pushable,
                            const int* cross_lab, const int* d_inf,
                            int* delta, int* new_lab, int K, int V, int E,
                            int mode, void* stream) {
  const long long rows = (long long)K * V;
  if (rows == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((rows + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      pr_phase_kernel<0><<<blocks, threads, 0, s>>>(
          lab, cf, sink_cf, excess, nbr, intra, pushable, cross_lab, d_inf,
          delta, new_lab, K, V, E);
      break;
    case 1:
      pr_phase_kernel<1><<<blocks, threads, 0, s>>>(
          lab, cf, sink_cf, excess, nbr, intra, pushable, cross_lab, d_inf,
          delta, new_lab, K, V, E);
      break;
    default:
      pr_phase_kernel<2><<<blocks, threads, 0, s>>>(
          lab, cf, sink_cf, excess, nbr, intra, pushable, cross_lab, d_inf,
          delta, new_lab, K, V, E);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
