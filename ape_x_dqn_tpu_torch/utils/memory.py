"""Host-memory hygiene for long runs.

Port of ``ape_x_dqn_tpu/utils/memory.py``.  A steady stream of
sub-mmap-threshold numpy buffers (observation batches, staged chunks,
snapshot scratch) lands in glibc's per-thread malloc arenas, whose freed
chunks are not returned to the OS, so a process's resident size grows
linearly without any Python-object leak.  ``trim_malloc()`` after each
collect or train quantum hands the free lists back.

``trim_malloc()`` is safe everywhere: on a non-glibc platform it does
nothing.
"""

from __future__ import annotations

import ctypes
import os

_libc = None
_checked = False


def trim_malloc() -> bool:
    """Release glibc arena free lists back to the OS; returns True if a
    trim actually ran (False on non-glibc platforms)."""
    global _libc, _checked
    if not _checked:
        _checked = True
        try:
            lib = ctypes.CDLL("libc.so.6", use_errno=True)
            lib.malloc_trim.argtypes = [ctypes.c_size_t]
            lib.malloc_trim.restype = ctypes.c_int
            _libc = lib
        except (OSError, AttributeError):
            _libc = None
    if _libc is None:
        return False
    _libc.malloc_trim(0)
    return True


_PAGE = None


def rss_bytes() -> int:
    """This process's resident set size in bytes (0 where /proc is
    unavailable); /proc/self/statm field 2 is resident pages."""
    global _PAGE
    if _PAGE is None:
        _PAGE = os.sysconf("SC_PAGESIZE")
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0
