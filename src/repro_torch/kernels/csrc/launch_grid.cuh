// The grid a launcher reports back to its caller: every extern "C" launcher
// of the port writes the grid it launched, (x, y, z), to an int[3] the
// caller passes, so the Python wrapper records the launch as it happened
// (kernels/introspect.py) and not as a second derivation of the grid.

#pragma once

#include <cuda_runtime.h>

__host__ inline void set_grid(int* launched, const dim3& grid) {
  launched[0] = int(grid.x);
  launched[1] = int(grid.y);
  launched[2] = int(grid.z);
}
