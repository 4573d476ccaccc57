"""Difficulty masks, tail packing, the search step and its CUDA kernels.

32-bit words.  CPU torch implements neither ``+``, ``<<``, ``>>``, ``~``,
``min`` nor ``arange`` for ``uint32`` tensors, and ``int32`` right shift
is arithmetic.  So the plain torch code carries every 32-bit word as an
``int64`` tensor holding a value in ``[0, 2^32)``, masked with
``0xFFFFFFFF`` after every add and left shift (``~x`` is written
``x ^ 0xFFFFFFFF``).  This is exact: the sum of a few 32-bit values and
a 32-bit value shifted left by at most 31 bits both fit in 63 bits.

Operands cross to the CUDA kernels as their ``uint32`` bit patterns in
``int32`` tensors (``operands.u32_tensor``), and a kernel's result
cell is an ``int32`` tensor read back as an unsigned value, so the miss
value stays ``SENTINEL = 0xFFFFFFFF``.
"""
