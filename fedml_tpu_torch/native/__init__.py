"""Native (C++) host-side components (copy of ``fedml_tpu/native``).

The per-round client-shard packer's row gather (``gather_rows``), built
on demand with the system ``g++`` and loaded with ctypes.  Every entry
point has a numpy fallback, so the package works where no toolchain
exists (``FEDML_TPU_NO_NATIVE=1`` forces it); ``native_available`` says
which one runs.
"""

from fedml_tpu_torch.native.packer import gather_rows, native_available

__all__ = ["gather_rows", "native_available"]
