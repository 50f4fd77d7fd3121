"""Device-op profiler: trace reduction + trace integration."""

import numpy as np
from jax.profiler import ProfileData

from nns.utils.profiling import DeviceOpReport, parse_xplane, profile_device_ops

# An XSpace as jax.profiler writes it on a GPU: one /device:GPU:0 plane with
# one line per CUDA stream, plus a host plane the reduction must ignore.
_GPU_TRACE = """
planes {
  name: "/device:GPU:0"
  lines {
    name: "Stream #7(Compute)"
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000000 }
    events { metadata_id: 2 offset_ps: 3000000000 duration_ps: 1000000000 }
    events { metadata_id: 3 offset_ps: 5000000000 duration_ps: 500000000 }
  }
  lines {
    name: "Stream #9(MemcpyH2D)"
    events { metadata_id: 4 offset_ps: 0 duration_ps: 250000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "fusion.1" } }
  event_metadata { key: 2 value { id: 2 name: "fusion.7" } }
  event_metadata { key: 3 value { id: 3 name: "cell_scan" } }
  event_metadata { key: 4 value { id: 4 name: "MemcpyH2D" } }
}
planes {
  name: "/host:CPU"
  lines { name: "python" events { metadata_id: 1 duration_ps: 7000000000 } }
  event_metadata { key: 1 value { id: 1 name: "fusion.1" } }
}
"""


def test_parse_xplane_synthetic(tmp_path):
    p = tmp_path / "vm.xplane.pb"
    p.write_bytes(ProfileData.text_proto_to_serialized_xspace(_GPU_TRACE))

    rep = parse_xplane(str(p))
    assert rep.devices == ["/device:GPU:0"]
    assert rep.ops["fusion"] == (2, 3.0)  # .N numbering folds into one kind
    assert rep.ops["cell_scan"] == (1, 0.5)
    assert rep.ops["MemcpyH2D"] == (1, 0.25)
    assert abs(rep.total_ms - 3.75) < 1e-9  # the host plane is not counted
    assert rep.top(1) == [("fusion", 2, 3.0)]
    assert "cell_scan" in str(rep)


def test_profile_device_ops_runs():
    # Integration: trace a tiny jitted computation; the report must come
    # back well-formed whatever the backend names its device plane.
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: jnp.sum(x * 2.0 + 1.0))

    def run():
        np.asarray(f(jnp.arange(1024.0)))

    run()  # compile outside the trace
    rep = profile_device_ops(run)
    assert isinstance(rep, DeviceOpReport)
    assert isinstance(rep.total_ms, float)
    # The CPU backend has no /device: plane; an empty-but-well-formed
    # report is the contract there.
    assert isinstance(rep.ops, dict)
