"""Loop-level numpy transliteration of mg_1d_old.c:27-158.

Exists purely as the C-parity oracle for multigrid_parallel.cascade
(same role golden3d.py plays for the 3D kernels): sequential strided
Gauss-Seidel, in-place residual/restriction into the shared flat arrays,
the unfilled coarse RHS (b stays zero, mg_1d_old.c:99-110), midpoint
interpolation-add and original-RHS up-leg smoothing.
"""

import numpy as np


def cascade_golden(coarse_n, num_levels, gs_iters, func=lambda x: x,
                   rhs_func=lambda x: 0.0):
    mult = 1 << (num_levels - 1)
    nf = (coarse_n - 1) * mult + 1
    v = np.zeros(nf)
    f = np.zeros(nf)
    r = np.zeros(nf)
    v[0] = func(0.0)
    v[-1] = func(1.0)
    n = nf
    h = 1.0 / (n - 1)
    for i in range(nf):
        f[i] = rhs_func(i * h)

    # down leg (mg_1d_old.c:62-90)
    m = 1
    for _ in range(num_levels - 1, 0, -1):
        h2 = h * h
        for _p in range(gs_iters):
            for j in range(m, (n - 1) * m, m):
                v[j] = (v[j - m] + v[j + m] - h2 * f[j]) / 2
        for j in range(m, (n - 1) * m, m):
            r[j] = f[j] - (v[j - m] + v[j + m] - 2 * v[j]) / h2
        for j in range(2 * m, (n - 1) * m, 2 * m):
            f[j] = 0.25 * (r[j - m] + r[j + m]) + 0.5 * r[j]
        h *= 2
        m *= 2
        n = (n + 1) // 2

    # coarse direct solve (mg_1d_old.c:92-119); b never filled -> x = 0,
    # reproduced literally
    a_mat = np.zeros((n, n))
    b = np.zeros(n)
    a_mat[0, 0] = 1.0
    for i in range(1, n - 1):
        a_mat[i, i - 1] = -1.0
        a_mat[i, i] = 2.0
        a_mat[i, i + 1] = -1.0
    a_mat[n - 1, n - 1] = 1.0
    xs = np.linalg.solve(a_mat, b)
    for i in range(1, n - 1):
        v[i * m] = xs[i]

    # up leg (mg_1d_old.c:122-144)
    for _ in range(1, num_levels):
        h /= 2
        n = 2 * n - 1
        m //= 2
        for j in range(m, (n - 1) * m, 2 * m):
            v[j] += (v[j - m] + v[j + m]) / 2
        h2 = h * h
        for _p in range(gs_iters):
            for j in range(m, (n - 1) * m, m):
                v[j] = (v[j - m] + v[j + m] - h2 * rhs_func(j * h)) / 2

    err = 0.0
    for i in range(nf):
        d = v[i] - func(i * h)
        err += d * d
    return v, err
