"""One fused force step of the continuity tier (``force_step_cont``:
pressure and viscosity with the carried density's EOS, the continuity
sum, integration, walls, obstacles, mover flag): positions, velocities and
the carried density read once (float32), positions, velocities and next
step's density written once (float32) and the mover flag (one byte).

Operations per ordered pair within h, from the kernel's pair body
(``csrc/force.cu``, form ``rate`` with the clamped correction, beta 1, as
the configuration runs it): force_step's 32 (the difference (3), r^2 (5),
the clamped rsqrt (2), r (1), h - r clamped (2), the pressure sum (1),
coef_p (3), coef_v (2), the viscosity sum (1), the three accumulations
(12)) and the continuity sum's 17: the velocity difference dotted with
the distance (8), h^2 - r^2 clamped (2), its square (1), times the dot
(1), the correction scaled, clamped both ways and taken off the pressure
sum (4), and the rate sum (1)."""


def count(n: int, pairs: float, dim: int):
    return (n * (2 * dim * 4 + 4 + 2 * dim * 4 + 4 + 1),
            (32.0 + 17.0) * pairs)
