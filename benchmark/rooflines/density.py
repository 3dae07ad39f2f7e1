"""One summation-density sweep: each particle's position read once, its
density written once (float32), and 13 float32 operations per term of the
sum (the kernel's arithmetic: the difference (3), r^2 (5), h^2 - r^2, its
cube (2), the scaled sum (2)), one term per ordered pair within h and one
for the particle itself."""


def count(n: int, pairs: float, dim: int):
    return n * (dim * 4 + 4), 13.0 * (pairs + n)
