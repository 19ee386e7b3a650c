"""The host runtime (C++ via ctypes): sample rings, the sliding capture
window, the window pool and shared-memory payload IPC (runtime.py)."""

from mercury_tpu_torch.runtime.runtime import (  # noqa: F401
    SampleRing, ShmPayloadRing, SlidingWindow, WindowPool, ensure_built,
)
