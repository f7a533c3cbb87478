// The grid a launcher reports back to its caller: every extern "C" launcher
// of the port writes the grid it launched, (x, y, z), to an int[3] the
// caller passes, so the Python wrapper records the launch as it happened
// (kernels/introspect.py) and not as a second derivation of the grid.
//
// The events around a launcher's work: every extern "C" launcher takes two
// cudaEvent_t (null when the caller times nothing) and records the first
// on its stream before its launch and the second after it, inside the one
// call, so the time between them is the card's alone and holds none of the
// host's work around the call (kernels/introspect.py::launch_window).

#pragma once

#include <cuda_runtime.h>

__host__ inline void set_grid(int* launched, const dim3& grid) {
  launched[0] = int(grid.x);
  launched[1] = int(grid.y);
  launched[2] = int(grid.z);
}

struct TimedLaunch {
  cudaEvent_t end;
  cudaStream_t stream;
  __host__ TimedLaunch(void* start, void* end_, cudaStream_t s)
      : end(static_cast<cudaEvent_t>(end_)), stream(s) {
    if (start) cudaEventRecord(static_cast<cudaEvent_t>(start), s);
  }
  __host__ ~TimedLaunch() {
    if (end) cudaEventRecord(end, stream);
  }
};
