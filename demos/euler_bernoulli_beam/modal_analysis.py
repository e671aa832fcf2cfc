"""Modal analysis of a cantilevered Euler-Bernoulli beam with a pure
displacement (C^1 cubic spline) formulation; natural frequencies compared
with the analytic spectrum.  Mirror of
demos/euler-bernoulli-beam/modal-analysis.py.
"""

import math

import numpy as np

from tigar_tpu.ops.knots import uniform_knots
from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
from tigar_tpu.models.space import EqualOrderSpline
from tigar_tpu.models.extracted import ExtractedSpline
from tigar_tpu.solvers.eigen import smallest_modes

p = 3
NEL = 100
L = 1.0

mesh = ExplicitBSplineControlMesh([p], [uniform_knots(p, 0.0, L, NEL)])
gen = EqualOrderSpline(1, mesh)
basis = gen.get_scalar_spline()
# clamped end: two layers of control points
gen.add_zero_dofs(0, basis.side_dofs(0, 0, n_layers=2))

spline = ExtractedSpline(gen, quad_degree=2 * p, nders=2)

E = I = mu = 1.0


def a(ctx, u, v):
    return E * I * ctx.lap(u) * ctx.lap(v)


def b(ctx, u, v):
    return mu * u.val * v.val


# BC diag shifted high so constrained modes go to the top of the spectrum
A = spline.assemble_matrix(a, diag=1e14)
B = spline.assemble_matrix(b, diag=1.0)

lam, modes = smallest_modes(A, B, 5)
beta_l = [1.87510406871196, 4.69409113297417, 7.85475743823761,
          10.99554073487547, 14.13716839104647]
for n in range(5):
    omega = math.sqrt(float(lam[n]))
    print(f"omega_{n} = {omega}   (analytic: {beta_l[n] ** 2})")

# -- optional on-chip matrix path (MODAL_DEVICE=1) ---------------------------
# The restarted Arnoldi solver keeps its Krylov basis on device and
# orthogonalizes with batched CGS2 dots -- the only host syncs are one
# Hessenberg fetch per restart.  Here the pencil is shift-inverted once
# (tiny 1D operator) and the Arnoldi iteration itself runs entirely on
# the device.
import os

if os.environ.get("MODAL_DEVICE", "0") == "1":
    import time
    import jax
    from tigar_tpu.solvers.eigen import arnoldi_eigs
    from tigar_tpu.solvers.linear import solve_dense
    from tigar_tpu.config import configure_compilation_cache

    configure_compilation_cache()
    OpInv = solve_dense(A, B)  # A^-1 B
    op = jax.jit(lambda x: OpInv @ x)

    t0 = time.time()
    lam_inv, X, res = arnoldi_eigs(op, 5, A.shape[0], n_krylov=30,
                                   which="LM", tol=1e-9)
    _ = np.asarray(X)
    dt_cold = time.time() - t0
    t0 = time.time()
    lam_inv, X, res = arnoldi_eigs(op, 5, A.shape[0], n_krylov=30,
                                   which="LM", tol=1e-9)
    _ = np.asarray(X)
    dt = time.time() - t0
    print(f"device Arnoldi ({jax.devices()[0].platform}): "
          f"{dt:.2f}s warm ({dt_cold:.2f}s cold incl. compile), "
          f"residuals {np.max(res):.2e}")
    for n in range(5):
        omega = math.sqrt(1.0 / float(lam_inv[n].real))
        print(f"omega_{n} (Arnoldi) = {omega}   (analytic: "
              f"{beta_l[n] ** 2})")
