"""Threaded batch image loader (native decode threads + ordered take).

The analogue of the reference's camera grabber thread
(QImageAcquisition, src/CameraPreviewDialog.cpp:42-131): decode on CPU
threads while the device crunches the previous batch.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from . import get_lib


class BatchLoader:
    """Decodes a list of BMPs concurrently; take(i) blocks until ready."""

    def __init__(self, paths: List[str], n_threads: int = 4):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.fipm_loader_create(arr, len(self._paths),
                                              n_threads)
        self._n = len(paths)

    def take(self, index: int) -> Optional[np.ndarray]:
        if not (0 <= index < self._n):
            raise IndexError(index)
        w = ctypes.c_int()
        h = ctypes.c_int()
        if not self._lib.fipm_loader_shape(self._handle, index,
                                           ctypes.byref(w), ctypes.byref(h)):
            return None
        out = np.empty((h.value, w.value), np.uint8)
        if not self._lib.fipm_loader_take(
                self._handle, index,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))):
            return None
        return out

    def close(self):
        if self._handle:
            self._lib.fipm_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
