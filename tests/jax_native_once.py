"""Load the JAX package's host library (``pronerf_tpu.native``) in this
process, one process at a time, for the tests that hold the port's ray
pool to the JAX package's bit for bit.

On a fresh checkout the library's first load runs ``make``, which writes
``libpronerf_native.so`` in place. Under ``pytest -n`` a worker that loads
the file while another is still writing it gets an ``OSError`` from
``CDLL``, remembers the library as missing and falls back to the NumPy
pool, which the pool tests then find unequal to the port's. Here the build
or load runs under an ``fcntl`` lock (``native/.build.lock``, beside the
Makefile), and a load that failed earlier in this process, before the lock
was taken, is tried once more under it.

Call ``load()`` when a test file that compares the two pools is imported.
"""

import fcntl
from pathlib import Path

LOCK = Path(__file__).resolve().parents[1] / "native" / ".build.lock"


def load() -> bool:
    """True when ``pronerf_tpu.native`` holds its library."""
    import pronerf_tpu.native as native

    with open(LOCK, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if native._lib is None:
                native._tried = False
            return native.is_available()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
