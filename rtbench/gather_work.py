"""The row gather's work, for its share of its roofline.

The gather (``csrc/gather.cu::gather_kernel`` of the program, launched by
its ``ops/fetch_cuda.py``) writes ``width`` f32 values for each of the
``N`` ids it is given.  The bytes that must reach memory are those rows:
the program counts them from the shapes, rows in ``fetch.rows`` and values
(rows times their width) in ``fetch.values``.  The ids it reads and the
table rows are left out: the city's 131,072-row payload table is about
14 MB and can sit in the H100's 50 MB L2, so counting its reads could
put the share over 100%.

The kernel's device time is read by its full name as the trace prints it,
``(anonymous namespace)::gather_kernel<...>(...)`` with or without a
leading ``void``, which no kernel of torch's has (torch's own gathers are
``at::native::...``).
"""
from __future__ import annotations

import re

KERNEL = re.compile(r"^(void )?\(anonymous namespace\)::gather_kernel<"
                    r"(true|false)>\(")
VALUE_BYTES = 4          # f32


def is_gather(name: str) -> bool:
    return KERNEL.match(name) is not None


def written_bytes(values: float) -> float:
    """The bytes of ``values`` f32 values written: rows times width times
    4, summed over the calls."""
    return values * VALUE_BYTES


def kernel_s(trace) -> float:
    """Device seconds of the gather's launches in the window ``trace``
    (:class:`rtbench.yardstick.Trace`)."""
    return sum(e - s for k, s, e in trace.device if is_gather(k)) / 1e6
