"""Host utilities of the port: bit math, hex, logging, timing."""

from .bitmath import bit_reverse_indices, ceil_log2, is_pow2, largest_pow2_le
from .timing import StopWatch
