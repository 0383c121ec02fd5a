"""Bytes and float32 operations of the physics of one batched env step, and
the least time an H100 needs for them.

The arithmetic of `chip_smoke.py` `bound()` and `OPS_PER_ITEM`, frozen here
so that the program cannot change the yardstick: each operand is read or
written once (float32), operations per item as counted from the kernels'
sources (an add, multiply, compare, sqrt, exp or log one, an fma two). It
counts the work that a step needs, whatever implements it, and so touches
the grid only at the cells with mass (the 27-cell stencils of the
particles; about 1% of a 64^3 grid at Move-v1), as a sparse grid would:
per substep the stress update, the P2G scatter (its sums written once at
the cells with mass; no clear of the rest of the grid), the grid update
(read and written at the cells with mass), the G2P gather (the grid read at
the cells with mass); per env step the mass P2G for the loss. Sorting,
launch overheads and the loss are not counted. The least time is a lower
bound, so a share of it stays under 100% whatever implements the step.
"""
from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense, at 700 W
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

F32 = 4
OPS_PER_PARTICLE = {"stress": 2093, "p2g": 900, "g2p": 700, "grid_mass": 150}
OPS_PER_MASS_CELL = {"grid_op": 300}


def substep(B: int, n: int, mass_cells: int):
    """(bytes, operations) of one substep of B envs of n particles with
    `mass_cells` cells with mass over all envs."""
    P = B * n
    nbytes = (P * 36 * F32                              # stress: C, F in; F, affine out
              + P * 15 * F32 + mass_cells * 4 * F32     # P2G: x, v, affine in; grid out
              + mass_cells * (4 + 3) * F32              # grid update: grid in, velocities out
              + P * 3 * F32 + mass_cells * 3 * F32 + P * 15 * F32)  # G2P
    ops = (P * (OPS_PER_PARTICLE["stress"] + OPS_PER_PARTICLE["p2g"] + OPS_PER_PARTICLE["g2p"])
           + mass_cells * OPS_PER_MASS_CELL["grid_op"])
    return nbytes, ops


def grid_mass(B: int, n: int, mass_cells: int):
    """(bytes, operations) of the mass P2G of B envs for the loss."""
    return B * n * 3 * F32 + mass_cells * F32, B * n * OPS_PER_PARTICLE["grid_mass"]


def least_time(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S)


def env_step_least_s(B: int, n: int, substeps: int, mass_cells: int) -> float:
    """Least seconds of one batched env step's physics: per substep the
    larger of its bytes and its operations, summed, plus the mass P2G."""
    return (substeps * least_time(*substep(B, n, mass_cells))
            + least_time(*grid_mass(B, n, mass_cells)))
