"""The bench's device-time reduction on small synthetic profiler traces."""

import pytest
from jax import profiler

import bench

GPU_TRACE = '''
planes { id: 1 name: "/device:GPU:0"
  lines { id: 1 name: "Stream #13(Compute)" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000 }
    events { metadata_id: 2 offset_ps: 3000000 duration_ps: 1000000 } }
  lines { id: 2 name: "Stream #14(Compute)" timestamp_ns: 1000
    events { metadata_id: 2 offset_ps: 1500000 duration_ps: 1000000 } }
  lines { id: 3 name: "XLA Ops" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 9000000 } }
  event_metadata { key: 1 value { id: 1 name: "loop_fusion" } }
  event_metadata { key: 2 value { id: 2 name: "scatter" } }
}
planes { id: 2 name: "/host:CPU"
  lines { id: 1 name: "python" timestamp_ns: 0
    events { metadata_id: 1 offset_ps: 0 duration_ps: 50000000 } }
  event_metadata { key: 1 value { id: 1 name: "pjit" } }
}
'''


def test_busy_time_is_union_of_stream_kernels():
    """Stream kernels [0,2) + [1.5,2.5) + [3,4) us overlap to 3.5 us of
    busy time; derived lines and host planes do not count."""
    prof = profiler.ProfileData.from_text_proto(GPU_TRACE)
    assert bench.device_busy_ns(prof) == pytest.approx(3500.0)


def test_trace_without_gpu_kernels_fails():
    host_only = GPU_TRACE[GPU_TRACE.index("planes { id: 2"):]
    prof = profiler.ProfileData.from_text_proto(host_only)
    with pytest.raises(RuntimeError, match="no GPU kernel"):
        bench.device_busy_ns(prof)
