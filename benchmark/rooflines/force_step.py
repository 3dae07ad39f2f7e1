"""One fused force step (pressure and viscosity, EOS, integration, walls,
obstacles, mover flag): positions, velocities and density read once
(float32), positions and velocities written once (float32) and the mover
flag (one byte); 32 float32 operations per ordered pair within h (the
kernel's pair arithmetic as counted for the port's kernel bounds)."""


def count(n: int, pairs: float, dim: int):
    return n * (2 * dim * 4 + 4 + 2 * dim * 4 + 1), 32.0 * pairs
