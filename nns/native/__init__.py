"""Native C++ runtime layer (host-side components).

The reference's host-side work — linear scan (core.cu:11-54), KD-tree build
(core.cu:1092-1114), octree build (core.cu:1525-1566), parallel data
generation (core.cu:1913-1922) — is C++ there and C++ here: see nns_cpu.cpp,
compiled on demand with g++ -O3 -fopenmp and loaded via ctypes. Everything
degrades gracefully to numpy when the shared library isn't built (the same
capability-fallback contract the reference applies to missing GPUs,
core.cu:774-775).
"""

from nns.native.build import (  # noqa: F401
    ensure_built,
    load_library,
    native_available,
    native_cells_build,
    native_cells_stage,
    native_kd_build,
    native_kd_query,
    native_linear_scan,
    native_octree_build,
    native_octree_query,
)
