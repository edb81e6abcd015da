"""Test start-up: the JAX package's native library, built once.

``metabuli_tpu.native`` builds its library without a lock between
processes, and a pytest-xdist worker that loses the race keeps no library
for its life, so the tests that need it skip. Here each pytest process
(the controller first, then every worker, before collection) loads it
under the lock file that ``tests/helpers/jax_native.py`` takes: the first
builds, every later one finds a library newer than its sources and loads
it.
"""

import fcntl
import os


def pytest_configure(config):
    try:
        from metabuli_tpu import native
    except ImportError:  # a machine without JAX: the port's tests only
        return
    lock = os.path.join(os.path.dirname(native.__file__),
                        "libmetabuli_native.so.lock")
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        native.get_lib()
