"""Loop-level numpy golden implementations of the 3D kernels.

These re-implement the *semantics* of the reference C kernels
(mg_3d.h:640-1145) as straightforward in-place numpy loops, serving as the
unit-test oracle for the vectorized jnp ops. Small grids only.
"""

import numpy as np

RED, BLACK = 1, 0


def smooth_at(v, f, h2, i, j, k):
    # smoothenAtIndex (mg_3d.h:438-443), same neighbor addition order.
    v[i, j, k] = (
        v[i - 1, j, k]
        + v[i + 1, j, k]
        + v[i, j - 1, k]
        + v[i, j + 1, k]
        + v[i, j, k - 1]
        + v[i, j, k + 1]
        - h2 * f[i, j, k]
    ) * (1.0 / 6.0)


def rb_sweep(v, f, h, n_iter, red_first=True):
    """preSmoother/postSmoother (mg_3d.h:640-781): per iteration, one RED
    sweep then one BLACK sweep (or the reverse), sequential loop order."""
    n = v.shape[0]
    h2 = h * h
    colors = (RED, BLACK) if red_first else (BLACK, RED)
    for _ in range(n_iter):
        for color in colors:
            for i in range(1, n - 1):
                for j in range(1, n - 1):
                    # k offset per mg_3d.h:669/693
                    k0 = 1 + (i + j) % 2 if color == RED else 1 + (i + j + 1) % 2
                    for k in range(k0, n - 1, 2):
                        smooth_at(v, f, h2, i, j, k)
    return v


def residual(v, f, h):
    # calculateResidual (mg_3d.h:794-842); boundary entries stay zero.
    n = v.shape[0]
    inv_h2 = 1.0 / (h * h)
    r = np.zeros_like(v)
    for i in range(1, n - 1):
        for j in range(1, n - 1):
            for k in range(1, n - 1):
                s = (
                    v[i - 1, j, k]
                    + v[i + 1, j, k]
                    + v[i, j - 1, k]
                    + v[i, j + 1, k]
                    + v[i, j, k - 1]
                    + v[i, j, k + 1]
                    - 6.0 * v[i, j, k]
                )
                r[i, j, k] = f[i, j, k] - inv_h2 * s
    return r


def restrict(r, nc):
    # restrictResidual (mg_3d.h:844-998): boundary injection + interior
    # 27-point full weighting with the explicit weight table.
    w = np.zeros((3, 3, 3))
    for di in range(3):
        for dj in range(3):
            for dk in range(3):
                w[di, dj, dk] = (1.0 / 8.0) * 0.5 ** (
                    abs(di - 1) + abs(dj - 1) + abs(dk - 1)
                )
    d = np.zeros((nc, nc, nc), dtype=r.dtype)
    # boundary faces: injection
    for jc in range(nc):
        for kc in range(nc):
            d[0, jc, kc] = r[0, 2 * jc, 2 * kc]
            d[nc - 1, jc, kc] = r[2 * (nc - 1), 2 * jc, 2 * kc]
    for ic in range(nc):
        for kc in range(nc):
            d[ic, 0, kc] = r[2 * ic, 0, 2 * kc]
            d[ic, nc - 1, kc] = r[2 * ic, 2 * (nc - 1), 2 * kc]
    for ic in range(nc):
        for jc in range(nc):
            d[ic, jc, 0] = r[2 * ic, 2 * jc, 0]
            d[ic, jc, nc - 1] = r[2 * ic, 2 * jc, 2 * (nc - 1)]
    # interior
    for ic in range(1, nc - 1):
        for jc in range(1, nc - 1):
            for kc in range(1, nc - 1):
                val = 0.0
                for di in range(3):
                    for dj in range(3):
                        for dk in range(3):
                            val += (
                                r[2 * ic - 1 + di, 2 * jc - 1 + dj, 2 * kc - 1 + dk]
                                * w[di, dj, dk]
                            )
                d[ic, jc, kc] = val
    return d


def prolong_correct(ec, ef):
    # prolongateAndCorrectError (mg_3d.h:1000-1145) parity case analysis.
    nf = ef.shape[0]
    for i in range(nf):
        for j in range(nf):
            for k in range(nf):
                oi, oj, ok = i % 2, j % 2, k % 2
                val = oi + oj + ok
                if val == 3:
                    li, lj, lk = (i - 1) // 2, (j - 1) // 2, (k - 1) // 2
                    ret = (
                        ec[li, lj, lk]
                        + ec[li, lj, lk + 1]
                        + ec[li, lj + 1, lk]
                        + ec[li, lj + 1, lk + 1]
                        + ec[li + 1, lj, lk]
                        + ec[li + 1, lj, lk + 1]
                        + ec[li + 1, lj + 1, lk]
                        + ec[li + 1, lj + 1, lk + 1]
                    ) * 0.125
                elif val == 2:
                    if oi == 0:
                        li, lj, lk = i // 2, (j - 1) // 2, (k - 1) // 2
                        ret = (
                            ec[li, lj, lk]
                            + ec[li, lj + 1, lk]
                            + ec[li, lj, lk + 1]
                            + ec[li, lj + 1, lk + 1]
                        ) * 0.25
                    elif oj == 0:
                        li, lj, lk = (i - 1) // 2, j // 2, (k - 1) // 2
                        ret = (
                            ec[li, lj, lk]
                            + ec[li + 1, lj, lk]
                            + ec[li, lj, lk + 1]
                            + ec[li + 1, lj, lk + 1]
                        ) * 0.25
                    else:
                        li, lj, lk = (i - 1) // 2, (j - 1) // 2, k // 2
                        ret = (
                            ec[li, lj, lk]
                            + ec[li, lj + 1, lk]
                            + ec[li + 1, lj, lk]
                            + ec[li + 1, lj + 1, lk]
                        ) * 0.25
                elif val == 1:
                    if oi == 1:
                        li, lj, lk = (i - 1) // 2, j // 2, k // 2
                        ret = (ec[li, lj, lk] + ec[li + 1, lj, lk]) * 0.5
                    elif oj == 1:
                        li, lj, lk = i // 2, (j - 1) // 2, k // 2
                        ret = (ec[li, lj, lk] + ec[li, lj + 1, lk]) * 0.5
                    else:
                        li, lj, lk = i // 2, j // 2, (k - 1) // 2
                        ret = (ec[li, lj, lk] + ec[li, lj, lk + 1]) * 0.5
                else:
                    ret = ec[i // 2, j // 2, k // 2]
                ef[i, j, k] += ret
    return ef
