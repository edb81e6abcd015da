"""The JAX package's native library, loaded in this test process.

``metabuli_tpu.native`` builds its library without a lock between
processes, every builder writing the same temporary file, and gives up for
the life of the process when its build or rename fails. Test modules call
it at import, so pytest-xdist workers race there, and a worker that loses
runs the JAX package on its pure-Python fallbacks, whose DB bytes differ
from the native path's (and so from the port's). The race is over once a
worker runs a test: ``loaded()`` loads the finished library again, one
process at a time, so that the tests that hold the port equal to the JAX
package compare it with the JAX package's native path wherever they run.
"""

import fcntl
import os


def loaded():
    from metabuli_tpu import native

    if native.get_lib() is None:
        lock = os.path.join(os.path.dirname(native.__file__),
                            "libmetabuli_native.so.lock")
        with open(lock, "w") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            native._TRIED = False
            native.get_lib()
    assert native.get_lib() is not None, "the JAX native library failed"
    return native.get_lib()
