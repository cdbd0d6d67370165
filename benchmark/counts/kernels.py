"""Bytes, operations and roofline bounds of the decode cell's kernels.

A bound counts each input read once and each output written once,
whatever the kernel reads again, and the gate convolution's operations
(2 a multiply-add) over the cell's state and up-input; the skip part of
the gates is hoisted out of the step and arrives as one (B, H, 4C, W)
term. The bound of a launch is the larger of bytes over the HBM rate and
operations over the tensor-core rate of its dtype.

- K1 (the forward cell): reads h_prev, c_prev (B, H, C, W), the padded
  up-input (B, H+2, Cx, W+2), the skip term and the packed weight
  (4C, 9 (Cx + C)); writes h and c.
- K4 (the cell backward's gate gradient): reads K1's inputs and the
  cotangents dh, dc; writes the gate gradient (B, H, 4C, W) and dc_prev.
"""

from __future__ import annotations

from .peaks import ELEMENT_BYTES, HBM_BYTES_PER_S, OPS_PER_S


def gate_ops(b: int, h: int, w: int, c: int, cx: int) -> float:
    return 2.0 * 4 * c * 9 * (cx + c) * b * h * w


def k1_bytes(b: int, h: int, w: int, c: int, cx: int, elem: int) -> int:
    state = b * h * c * w
    x_pad = b * (h + 2) * cx * (w + 2)
    return elem * (2 * state + x_pad + 4 * state + 4 * c * 9 * (cx + c)
                   + 2 * state)


def k4_bytes(b: int, h: int, w: int, c: int, cx: int, elem: int) -> int:
    state = b * h * c * w
    return (k1_bytes(b, h, w, c, cx, elem) - 2 * state * elem
            + elem * (2 * state + 4 * state + state))


def bound_s(n_bytes: float, ops: float, dtype: str) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, ops / OPS_PER_S[dtype])


def step_bound_s(kernel: str, b: int, geoms, dtype: str) -> float:
    """Seconds of one decode step's five launches of ``kernel`` ("k1" or
    "k4") at their bounds, geoms from ``flops.cell_geometries``."""
    count = {"k1": k1_bytes, "k4": k4_bytes}[kernel]
    elem = ELEMENT_BYTES[dtype]
    return sum(bound_s(count(b, h, w, c, cx, elem), gate_ops(b, h, w, c, cx),
                       dtype) for h, w, c, cx in geoms)
