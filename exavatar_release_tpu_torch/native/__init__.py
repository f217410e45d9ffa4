"""Native (C++) runtime components: the threaded PNG decode and prefetch
loader (counterpart of exavatar_release_tpu/native/, built from the port's
own copy of the source)."""
from .loader import (NativeLoader, build_error, build_native, decode_png_native,
                     native_available)

__all__ = ["NativeLoader", "build_error", "build_native", "decode_png_native",
           "native_available"]
