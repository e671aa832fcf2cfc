"""Production-scale 3D Poisson on one device: ~1M DoFs solved fully
matrix-free to float64 accuracy.

Everything is sum-factorized (ops/sumfac.py): no dense tabulation, no
extraction matrix, no assembled operator -- the stiffness apply, the RHS,
and the error norm are all sliding-window contraction chains.

Two solver paths (SOLVER env var), at 96^3 (941k DoFs):
  mg (default): geometric-multigrid-preconditioned f64 CG with a float32
      V-cycle (5 nested levels, exact knot-insertion transfers,
      solvers/multigrid.py) -- 20 h-INDEPENDENT iterations to 8e-12
      relative residual with Jacobi V(2,2) smoothing.  Chebyshev
      smoothing (Multigrid.enable_chebyshev) reaches 5e-17 -- f64
      machine zero -- in the same 20 iterations at ~2x the per-cycle
      cost;
  refine: mixed-precision iterative refinement (f32 CG sweeps inside,
      f64 residuals outside, solvers/refinement.py) -- 5e-13, but the
      inner unpreconditioned CG iteration count grows ~1/h.
No H100 time is recorded yet.

(The dense per-element tabulation of this problem would occupy ~10 TB;
the reference's FE-extraction representation is larger still.)
"""

import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from tigar_tpu.ops.knots import uniform_knots
from tigar_tpu.models.bspline import TensorBSplineBasis
from tigar_tpu.models.space import SplineSpace
from tigar_tpu.ops.sumfac import (make_sumfac_identity_operator,
                                  sumfac_linear_form, sumfac_l2_error)
from tigar_tpu.solvers.refinement import refine_solve
from tigar_tpu.config import configure_compilation_cache

configure_compilation_cache()

p = int(os.environ.get("P", "2"))
NEL = int(os.environ.get("NEL", "96"))

basis = TensorBSplineBasis([p] * 3, [uniform_knots(p, 0.0, 1.0, NEL)] * 3)
ndof = basis.ncp
print(f"3D Poisson: p={p}, {NEL}^3 elements, {ndof:,} DoFs")

# homogeneous Dirichlet mask on all sides
mask_np = np.ones(ndof)
for d in range(3):
    for s in (0, 1):
        mask_np[basis.side_dofs(d, s)] = 0.0
mask64 = jnp.asarray(mask_np)
mask32 = mask64.astype(jnp.float32)


def soln(x, y, z):
    return (jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y) * jnp.sin(jnp.pi * z))


def f_rhs(x, y, z):
    return 3.0 * jnp.pi ** 2 * soln(x, y, z)


t0 = time.time()
b = sumfac_linear_form(basis, 2 * p, f_rhs) * mask64
op64 = make_sumfac_identity_operator(basis, 2 * p, mask=mask64)
b.block_until_ready()
print(f"setup + RHS: {time.time() - t0:.1f}s")

SOLVER = os.environ.get("SOLVER", "mg")

t0 = time.time()
if SOLVER == "mg":
    # Geometric multigrid (solvers/multigrid.py): f32 V-cycle
    # preconditioner inside f64 CG -- h-independent iteration counts, so
    # the whole solve is a fixed small number of fine-level applies.
    from tigar_tpu.solvers.multigrid import identity_poisson_multigrid
    from tigar_tpu.solvers.linear import cg_fixed_iters

    sizes = []
    n = NEL
    while n >= 6 and (not sizes or sizes[-1] % 2 == 0):
        sizes.append(n)
        n //= 2
    bases = [basis] + [TensorBSplineBasis(
        [p] * 3, [uniform_knots(p, 0.0, 1.0, s)] * 3) for s in sizes[1:]]
    masks = []
    for bs in bases:
        m = np.ones(bs.ncp)
        for d in range(3):
            for s in (0, 1):
                m[bs.side_dofs(d, s)] = 0.0
        masks.append(m)
    mg32 = identity_poisson_multigrid(bases, 2 * p, masks,
                                      dtype=jnp.float32)
    Mpre = lambda r: mg32(r.astype(jnp.float32)).astype(r.dtype)
    n_it = int(os.environ.get("MG_ITERS", "20"))
    U, r_vec = cg_fixed_iters(op64, b, n_it, M=Mpre)
    rel = float(jnp.linalg.norm(r_vec)) / float(jnp.linalg.norm(b))
    t_solve = time.time() - t0
    print(f"multigrid-CG solve ({len(bases)} levels, {n_it} iterations): "
          f"{t_solve:.1f}s incl. compile, relative residual {rel:.2e}")
    t0 = time.time()
    U2, r2 = cg_fixed_iters(op64, b, n_it, M=Mpre)
    rel2 = float(jnp.linalg.norm(r2)) / float(jnp.linalg.norm(b))
    print(f"multigrid-CG warm solve: {time.time() - t0:.1f}s "
          f"(relative residual {rel2:.2e})")
else:
    op32 = make_sumfac_identity_operator(basis, 2 * p, mask=mask32,
                                         dtype=jnp.float32)
    U, sweeps, rel = refine_solve(
        op64, op32, b, tol=1e-12, max_sweeps=30,
        inner_iters=int(os.environ.get("INNER", "50")))
    U.block_until_ready()
    t_solve = time.time() - t0
    print(f"mixed-precision solve: {t_solve:.1f}s, {sweeps} refinement "
          f"sweeps, relative residual {rel:.2e}")

err = float(sumfac_l2_error(basis, 2 * p, U, soln))
print(f"L2 error vs manufactured solution: {err:.3e} "
      f"(optimal O(h^{p + 1}) discretization error)")
