"""Two-patch Kirchhoff-Love shell with CONSISTENT Nitsche coupling,
solved by the production multipatch mixed-precision Newton tier.

A cantilever SVK plate occupying [0,2] x [0,1], clamped along x=0 and
loaded by a uniform transverse pressure, is split at x=1 into two
patches with NON-MATCHING knots across the interface (nel x nel
elements on the left, nel x (nel+4) on the right).  The patches are
weakly coupled by the symmetric interface Nitsche method DERIVED
AUTOMATICALLY from the shell energy density
(interface.EnergyNitscheCoupling on models/shell.svk_psi_surface): the
consistent flux terms are the AD derivatives of the membrane+bending
energy, so -- unlike a displacement/rotation penalty -- the coupling
carries NO O(1/beta) consistency error and needs only moderate
stabilization (beta_d ~ 10 (D/h^3 + E h / h), beta_r ~ 10 D/h).

Solver: solvers/newton_stencil_mp.MultiPatchStencilNewton -- per-patch
sliding-window stencil tangents, the exact dense interface tangent
block, per-patch knot-insertion multigrid transfers with interface
Schwarz smoothing, f32 production Newton steps and f64 polish to the
double-precision evaluation floor.

Verification printed (and enforced by tests/test_newton_mp.py):
  1. the polished f64 relative residual reaches the moderate-beta floor
     (orders below a penalty coupling of the same scale class);
  2. the interface displacement jump is discretization-scale;
  3. the tip deflection agrees with an INDEPENDENT single-patch solve
     of the same plate (same element size, conforming) to within
     discretization error.

Reference analog: tIGAr couples multipatch spaces with consistent UFL
interface forms inside solveNonlinearVariationalProblem
(tIGAr/common.py:1162-1173, 1304-1348); the reference demos never had a
shell coupling demo -- this surface is a capability superset.

Environment: TP_NEL (default 8: fine level 16 x {16,20} per patch),
TP_Q load, TP_COMPARE_PENALTY=1 adds a penalty-coupled solve of the
same system to compare floors; TP_DEV=cpu forces the CPU backend.
"""

import os
import time

import numpy as np
import jax

if os.environ.get("TP_DEV", "") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from tigar_tpu.ops.knots import uniform_knots
from tigar_tpu.models.bspline import (TensorBSplineBasis,
                                      ExplicitBSplineControlMesh)
from tigar_tpu.models.multipatch import (MultiPatchBSplineBasis,
                                         MultiPatchControlMesh)
from tigar_tpu.models.space import EqualOrderSpline
from tigar_tpu.models.extracted import ExtractedSpline
from tigar_tpu.models.shell import (precompute_shell_reference,
                                    svk_shell_adjoint, svk_psi_surface)
from tigar_tpu.interface import EnergyNitscheCoupling
from tigar_tpu.solvers.newton_stencil import StencilNewton
from tigar_tpu.solvers.newton_stencil_mp import MultiPatchStencilNewton

P = 2
E_MOD, NU, H_TH = 1.0e7, 0.3, 0.05
Q = float(os.environ.get("TP_Q", "0.05"))
NEL = int(os.environ.get("TP_NEL", "8"))     # coarsest-but-one per patch
D_BEND = E_MOD * H_TH ** 3 / 12.0 / (1.0 - NU ** 2)


def res_adj(ctx, u):
    """Hand-derived adjoint SVK shell residual + uniform pressure."""
    F = svk_shell_adjoint(ctx, u, E_MOD, NU, H_TH)
    return F._replace(val=F.val.at[2].add(-Q))


def shell_energy(ctx, u, params):
    return svk_psi_surface(ctx, u, params["E"], params["nu"], params["h"])


def build_two_patch(nel_x, nel_ay, nel_by):
    """Two flat patches side by side along x: [0,1] x [0,1] with
    nel_x x nel_ay elements and [1,2] x [0,1] with nel_x x nel_by
    (NON-MATCHING knots along the shared edge x=1)."""
    pa = TensorBSplineBasis([P, P], [uniform_knots(P, 0.0, 1.0, nel_x),
                                     uniform_knots(P, 0.0, 1.0, nel_ay)])
    pb = TensorBSplineBasis([P, P], [uniform_knots(P, 0.0, 1.0, nel_x),
                                     uniform_knots(P, 0.0, 1.0, nel_by)])
    basis = MultiPatchBSplineBasis([pa, pb])

    def bnet(patch, x_off):
        g = patch.greville_points()
        B = np.zeros((g.shape[0], 4))
        B[:, 0] = g[:, 0] + x_off
        B[:, 1] = g[:, 1]
        B[:, 3] = 1.0
        return B

    cm = MultiPatchControlMesh(basis, [bnet(basis.patches[0], 0.0),
                                       bnet(basis.patches[1], 1.0)])
    gen = EqualOrderSpline(3, cm)
    clamp = basis.patch_side_dofs(0, 0, 0, n_layers=2)   # clamp x=0 edge
    for i in range(3):
        gen.add_zero_dofs(i, clamp)
    sp = precompute_shell_reference(
        ExtractedSpline(gen, quad_degree=2 * P, nders=2))
    return sp


def nitsche_coupling(sp, nel_x):
    h = 1.0 / nel_x
    return EnergyNitscheCoupling(
        sp, 0, (0, 1), 1, (0, 0), shell_energy,
        beta_d=10.0 * (D_BEND / h ** 3 + E_MOD * H_TH / h),
        beta_r=10.0 * D_BEND / h, w_order=2,
        params={"E": E_MOD, "nu": NU, "h": H_TH})


def single_patch_reference(nel_x):
    """INDEPENDENT single-patch solve of the same [0,2] x [0,1] plate
    (conforming; 2*nel_x x nel_x elements) for the physical cross-check."""
    def build(n):
        kvecs = [uniform_knots(P, 0.0, 2.0, 2 * n),
                 uniform_knots(P, 0.0, 1.0, n)]
        cm = ExplicitBSplineControlMesh([P, P], kvecs, extra_dim=1)
        gen = EqualOrderSpline(3, cm)
        clamp = cm.scalar_basis().side_dofs(0, 0, n_layers=2)
        for i in range(3):
            gen.add_zero_dofs(i, clamp)
        return precompute_shell_reference(
            ExtractedSpline(gen, quad_degree=2 * P, nders=2))

    sp = build(nel_x)
    ns = StencilNewton(sp, res_adj,
                       mg_splines=[build(nel_x // 2), build(nel_x // 4)],
                       cg_iters=25, polish_cg_iters=40)
    U, rel, steps, _ = ns.solve(rtol=1e-10, max_iters=25)
    w_tip = float(sp.evaluate(U, np.asarray([[2.0, 0.5]]))[0, 2])
    return w_tip, rel, steps


def main():
    t0 = time.time()
    levels = [(2 * NEL, 2 * NEL, 2 * NEL + 4),
              (NEL, NEL, NEL + 2),
              (NEL // 2, NEL // 2, NEL // 2 + 1)]
    splines = [build_two_patch(*lv) for lv in levels]
    couplings = [nitsche_coupling(sp, lv[0])
                 for sp, lv in zip(splines, levels)]
    spline, coupling = splines[0], couplings[0]
    print(f"two-patch space: {spline.ndof} DoFs "
          f"({levels[0][0]}x{levels[0][1]} + {levels[0][0]}x{levels[0][2]} "
          f"elements, non-matching at x=1); setup {time.time() - t0:.1f}s")
    h_fine = 1.0 / levels[0][0]
    print(f"Nitsche stabilization: "
          f"beta_d={10.0 * (D_BEND / h_fine ** 3 + E_MOD * H_TH / h_fine):.3g}, "
          f"beta_r={10.0 * D_BEND / h_fine:.3g} (consistent flux from the "
          f"shell energy; no O(1/beta) consistency error)")

    t0 = time.time()
    ns = MultiPatchStencilNewton(
        spline, res_adj, coupling,
        mg_splines=splines[1:], mg_couplings=couplings[1:],
        cg_iters=25, polish_cg_iters=40)
    print(f"solver setup: {time.time() - t0:.1f}s")

    t0 = time.time()
    U, rel, steps, dU_rel = ns.solve(rtol=1e-10, max_iters=25,
                                     log=lambda s: print("  " + s))
    print(f"solve: {time.time() - t0:.1f}s, {steps} steps, "
          f"rel |r| = {rel:.3e}, |dU|/|U| = {dU_rel:.2e}")

    jump = float(coupling.jump_norm(U))
    w_tip = float(spline.evaluate(U, np.asarray([[1.0, 0.5]]),
                                  patch=1)[0, 2])
    print(f"interface displacement jump norm: {jump:.3e}")
    print(f"tip deflection w(2.0, 0.5) = {w_tip:.6e} "
          f"({abs(w_tip) / H_TH:.2f} x thickness)")

    w_ref, rel_ref, steps_ref = single_patch_reference(2 * NEL)
    print(f"single-patch reference (conforming): w_tip = {w_ref:.6e} "
          f"(rel |r| = {rel_ref:.1e}, {steps_ref} steps)")
    tip_err = abs(w_tip - w_ref) / abs(w_ref)
    print(f"two-patch vs single-patch tip deflection: "
          f"{tip_err * 100:.3f}% relative difference")
    assert rel < 5e-9, rel
    assert tip_err < 0.02, tip_err

    if os.environ.get("TP_COMPARE_PENALTY", "0") == "1":
        from tigar_tpu.coupling import ShellInterfaceCoupling
        h = 1.0 / levels[0][0]
        pens = [ShellInterfaceCoupling(
            sp, 0, (0, 1), 1, (0, 0),
            penalty_disp=1e2 * E_MOD * H_TH / h,
            penalty_rot=1e2 * E_MOD * H_TH ** 3 / h)
            for sp in splines]
        nsp = MultiPatchStencilNewton(
            spline, res_adj, pens[0],
            mg_splines=splines[1:], mg_couplings=pens[1:],
            cg_iters=25, polish_cg_iters=40)
        Up, relp, stepsp, _ = nsp.solve(rtol=1e-10, max_iters=25)
        wp = float(spline.evaluate(Up, np.asarray([[1.0, 0.5]]),
                                   patch=1)[0, 2])
        print(f"penalty comparison: rel floor {relp:.3e} (Nitsche "
              f"{rel:.3e}), tip {wp:.6e} "
              f"(vs single-patch err {abs(wp - w_ref) / abs(w_ref):.2%})")

    print("DONE")


if __name__ == "__main__":
    main()
