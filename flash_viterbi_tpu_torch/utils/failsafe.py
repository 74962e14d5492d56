"""Re-dispatch of a decode after a transient device failure.

Counterpart of ``flash_viterbi_tpu/utils/failsafe.py``.  The reference has
no recovery at all (``perror`` without exit on fopen/malloc failure,
``FLASH_Viterbi_multithread.c:67-99``).  Every decode of this package is a
pure function of tables and observations it was handed, so a failed call
can be issued again: there is no partial state to repair.
:func:`with_redispatch` is that policy; ``decode(..., retries=n)`` applies
it to the public entry point.

A retry issues the same decode on the same device again.  It never falls
back to the CPU or to a kernel's plain version, and the kernels' build
stays outside the retried call, so a failed build raises at once.

A retry cannot mend a sticky CUDA fault: after an illegal address or a
device-side assert the CUDA context is unusable, and every later call in
the process fails the same way until the process ends.  What a retry can
outlive is an error CUDA reports without poisoning the context, such
as a refused launch or an allocation that failed while other work held the
memory.

Fail-fast stays the default (``retries=0``), as in the reference.
"""

from __future__ import annotations

import time
from typing import Callable, TypeVar

T = TypeVar("T")

# Transient-looking failures: torch reports CUDA errors as RuntimeError
# (torch.AcceleratorError and torch.OutOfMemoryError subclass it), and the
# kernel wrappers raise it when a kernel reports a timed-out barrier.
TRANSIENT = (RuntimeError,)


def with_redispatch(fn: Callable[[], T], retries: int = 1,
                    backoff_s: float = 1.0, on: tuple | None = None) -> T:
    """Run ``fn`` and run it again after a transient failure.

    Args:
      fn: zero-argument callable issuing the (idempotent) device work; it
        should synchronise, so that an asynchronous CUDA error is raised
        inside it.
      retries: additional attempts after the first failure.
      backoff_s: sleep between attempts (doubles each retry).
      on: exception types counted as transient (default: ``TRANSIENT``).

    Raises the last exception when the attempts are exhausted, and any
    other exception at once.
    """
    errs = TRANSIENT if on is None else on
    delay = backoff_s
    for attempt in range(retries + 1):
        try:
            return fn()
        except errs:
            if attempt == retries:
                raise
            time.sleep(delay)
            delay *= 2
    raise AssertionError("unreachable")
