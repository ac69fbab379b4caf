// Kernel A: k complete push/relabel iterations of every region per launch.
//
// Replaces the TPU kernel
// repro/kernels/push_relabel.py::fused_engine_run_batched (program
// _fused_kernel_grid, body _fused_region_loop over make_fused_iteration,
// pl.pallas_call at push_relabel.py:451).  There, one program per region
// holds the whole region state in VMEM (12 MiB budget) and loops up to
// iter_limit iterations with an early exit.
//
// One iteration of region k, bit for bit the reference's:
//   push      every active vertex splits its excess over its admissible
//             arcs (exclusive prefix sum, sink column first), labels frozen;
//   scatter   intra-region pushes raise the reverse residual
//             cf[nbr*E + rev_slot] and the receiver's excess[nbr]; cross
//             pushes accumulate in out_push;
//   relabel   active vertices without an admissible arc on the post-push
//             graph go to max(min(1 + min residual neighbour label, d_inf),
//             lab), computed from the frozen labels.
// Accumulated per region: out_push, sink_pushed, relabel_sum, iters.
//
// What bounds it on the H100: bytes, and the SMs it can use.  A region of
// the main path (V = 16384, E = 4) is 256 KiB per [V, E] int32 array and
// about 2.8 MiB in all, more than a block's 227 KB of shared memory, so
// the state lives in device memory (mostly in L2) and every iteration
// streams it once more; the integer work per word is a handful of
// operations.  One block per region also leaves 132 - K SMs idle when
// K < 132.
//
// What the design does about it: one thread block (up to 1024 threads) per
// region and a loop inside the block in place of the TPU's sequential
// grid.  The wrapper copies cf/sink_cf/excess/lab into the outputs and the
// kernel updates them in place.  Each thread owns whole rows at a stride of
// blockDim; the push step writes only the thread's own rows and parks the
// intra-region deltas in a scratch [V, E]; after a barrier the scatter step
// applies them with integer atomicAdd (the only writes to another vertex's
// row; integer addition commutes, so the result is exact in any order);
// after a barrier the relabel step writes new labels into a scratch [V]
// (other threads still read lab[nbr]); after a barrier the label step
// copies them into lab and computes the next iteration's activity, which
// __syncthreads_or turns into the block's early-exit test.  sink_pushed and
// relabel_sum are per-thread int32 sums, reduced once at the end.  Keeping
// a region on chip (clusters with distributed shared memory, or a
// persistent grid) and spreading a region over several SMs are later work.

#include "common.cuh"

__global__ void __launch_bounds__(1024) fused_engine_kernel(
    const int* __restrict__ nbr, const int* __restrict__ rev_slot,
    const int* __restrict__ intra, const int* __restrict__ pushable,
    const int* __restrict__ cross_lab, const int* __restrict__ vmask,
    const int* __restrict__ d_inf, const int* __restrict__ limit,
    int* cf, int* sink_cf, int* excess, int* lab, int* out_push,
    int* sink_pushed, int* relabel_sum, int* iters, int* d_intra,
    int* new_lab, int V, int E, int sink_open) {
  const int k = blockIdx.x;
  const long long vo = (long long)k * V;
  const long long ao = vo * E;
  nbr += ao; rev_slot += ao; intra += ao; pushable += ao; cross_lab += ao;
  cf += ao; out_push += ao; d_intra += ao;
  vmask += vo; sink_cf += vo; excess += vo; lab += vo; new_lab += vo;
  const int dinf = d_inf[k];
  const int lim = limit[k];
  const int tid = threadIdx.x, nt = blockDim.x;

  int my_sink = 0, my_rls = 0, it = 0;
  int active = 0;
  for (int v = tid; v < V; v += nt)
    active |= excess[v] > 0 && lab[v] < dinf && vmask[v];

  while (it < lim) {
    if (!__syncthreads_or(active)) break;

    // ---- push: own rows only, from the pre-push state ----
    for (int v = tid; v < V; v += nt) {
      const long long b = (long long)v * E;
      const int my = lab[v];
      const int ex = excess[v];
      const bool act = ex > 0 && my < dinf && vmask[v];
      const int sk = sink_open ? sink_cf[v] : 0;
      const bool sink_adm = sk > 0 && my == 1 && act;
      const int avail = act ? ex : 0;
      int cum = sink_adm ? sk : 0;
      const int d_sink = min(max(avail, 0), cum);
      int pushed = d_sink;
      for (int e = 0; e < E; ++e) {
        const int c = cf[b + e];
        const bool in = intra[b + e] != 0;
        int nl = in ? lab[nbr[b + e]] : cross_lab[b + e];
        if (!pushable[b + e]) nl = PR_INF_LABEL;
        const int cap = (c > 0 && my == nl + 1 && act) ? c : 0;
        const int d = min(max(avail - cum, 0), cap);
        cum += cap;
        pushed += d;
        if (d) {
          cf[b + e] = c - d;
          if (!in) out_push[b + e] += d;
        }
        d_intra[b + e] = in ? d : 0;
      }
      if (pushed) excess[v] = ex - pushed;
      if (d_sink) {
        sink_cf[v] -= d_sink;
        my_sink += d_sink;
      }
    }
    __syncthreads();

    // ---- scatter: reverse arcs and receiver excess of intra pushes ----
    for (int v = tid; v < V; v += nt) {
      const long long b = (long long)v * E;
      for (int e = 0; e < E; ++e) {
        const int d = d_intra[b + e];
        if (d) {
          const int w = nbr[b + e];
          atomicAdd(&cf[(long long)w * E + rev_slot[b + e]], d);
          atomicAdd(&excess[w], d);
        }
      }
    }
    __syncthreads();

    // ---- relabel on the post-push graph, frozen labels ----
    for (int v = tid; v < V; v += nt) {
      const long long b = (long long)v * E;
      const int my = lab[v];
      const bool act = excess[v] > 0 && my < dinf && vmask[v];
      const int sk = sink_open ? sink_cf[v] : 0;
      const bool sink_adm = sk > 0 && my == 1 && act;
      bool any_adm = false;
      int cand = INT_MAX;
      for (int e = 0; e < E; ++e) {
        const int c = cf[b + e];
        int nl = intra[b + e] ? lab[nbr[b + e]] : cross_lab[b + e];
        if (!pushable[b + e]) nl = PR_INF_LABEL;
        any_adm |= c > 0 && my == nl + 1 && act;
        cand = min(cand, c > 0 ? nl + 1 : PR_INF_LABEL);
      }
      if (sk > 0) cand = min(cand, 1);
      const bool no_adm = act && !any_adm && !sink_adm;
      new_lab[v] = no_adm ? max(min(cand, dinf), my) : my;
    }
    __syncthreads();

    // ---- labels, relabel sum, next iteration's activity ----
    active = 0;
    for (int v = tid; v < V; v += nt) {
      const int nl = new_lab[v];
      const int vm = vmask[v];
      if (vm) my_rls += nl - lab[v];
      lab[v] = nl;
      active |= excess[v] > 0 && nl < dinf && vm;
    }
    ++it;
  }

  __shared__ int s_sink, s_rls;
  if (tid == 0) {
    s_sink = 0;
    s_rls = 0;
  }
  __syncthreads();
  atomicAdd(&s_sink, my_sink);
  atomicAdd(&s_rls, my_rls);
  __syncthreads();
  if (tid == 0) {
    sink_pushed[k] = s_sink;
    relabel_sum[k] = s_rls;
    iters[k] = it;
  }
}

extern "C" int fused_engine_i32(
    const int* nbr, const int* rev_slot, const int* intra,
    const int* pushable, const int* cross_lab, const int* vmask,
    const int* d_inf, const int* limit, int* cf, int* sink_cf, int* excess,
    int* lab, int* out_push, int* sink_pushed, int* relabel_sum, int* iters,
    int* d_intra, int* new_lab, int K, int V, int E, int sink_open,
    void* stream) {
  if (K == 0) return 0;
  int threads = ((V + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  fused_engine_kernel<<<K, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      nbr, rev_slot, intra, pushable, cross_lab, vmask, d_inf, limit, cf,
      sink_cf, excess, lab, out_push, sink_pushed, relabel_sum, iters,
      d_intra, new_lab, V, E, sink_open);
  return static_cast<int>(cudaGetLastError());
}
