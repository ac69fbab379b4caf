// Shared definitions of the port's push/relabel kernels.
#pragma once

#include <climits>
#include <cuda_runtime.h>

// label-infinity sentinel of the int32 policy (repro_torch.core.dtypes)
#define PR_INF_LABEL (1 << 30)

extern "C" const char* pr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
