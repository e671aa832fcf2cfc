"""Probe: the two-patch production bench point
driven by the CONSISTENT EnergyNitscheCoupling instead of the
displacement+rotation penalty.

Questions to answer (on CPU first, then the GPU):
  1. does MultiPatchStencilNewton converge with the Nitsche coupling and a
     PRODUCTIVE f32 production phase (no start_polish)?
  2. what floor does the f64 polish certify (penalty floored at ~7e-8 rel
     because pd ~ 2e9 amplifies interface-jump roundoff; Nitsche's beta_d
     is ~7.5x smaller at nel=64 and the converged jump is discretization-
     scale, not force-carrying)?
  3. step time vs the penalty point.

Usage:
  python scripts/probe_nitsche_mp.py [nel] [cpu|gpu] [nitsche|penalty]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

NEL = int(sys.argv[1]) if len(sys.argv) > 1 else 16
DEV = sys.argv[2] if len(sys.argv) > 2 else "cpu"
CPL = sys.argv[3] if len(sys.argv) > 3 else "nitsche"
BETA_C = float(sys.argv[4]) if len(sys.argv) > 4 else 10.0

if DEV == "cpu":
    jax.config.update("jax_platforms", "cpu")
else:
    from tigar_tpu.config import configure_compilation_cache
    configure_compilation_cache()

import jax.numpy as jnp

from tigar_tpu.ops.knots import uniform_knots
from tigar_tpu.models.bspline import TensorBSplineBasis
from tigar_tpu.models.multipatch import (MultiPatchBSplineBasis,
                                         MultiPatchControlMesh)
from tigar_tpu.models.space import EqualOrderSpline
from tigar_tpu.models.extracted import ExtractedSpline
from tigar_tpu.models.shell import (precompute_shell_reference,
                                    svk_shell_adjoint, svk_psi_surface)
from tigar_tpu.coupling import ShellInterfaceCoupling
from tigar_tpu.interface import EnergyNitscheCoupling
from tigar_tpu.solvers.newton_stencil_mp import MultiPatchStencilNewton

P = 2
E_MOD, NU, H_TH = 1.0e7, 0.3, 0.03
Q = 100.0


def build(nx, nay, nby):
    pa = TensorBSplineBasis(
        [P, P], [uniform_knots(P, 0.0, 1.0, nx),
                 uniform_knots(P, 0.0, 1.0, nay)])
    pb = TensorBSplineBasis(
        [P, P], [uniform_knots(P, 0.0, 1.0, nx),
                 uniform_knots(P, 0.0, 1.0, nby)])
    basis = MultiPatchBSplineBasis([pa, pb])

    def bnet(patch, x_off):
        g = patch.greville_points()
        B = np.zeros((g.shape[0], 4))
        B[:, 0] = g[:, 0] + x_off
        B[:, 1] = 2.0 * g[:, 1] - 1.0
        B[:, 3] = 1.0
        return B

    cm = MultiPatchControlMesh(
        basis, [bnet(basis.patches[0], -1.0), bnet(basis.patches[1], 0.0)])
    gen = EqualOrderSpline(3, cm)
    for i in range(3):
        gen.add_zero_dofs(i, basis.patch_side_dofs(0, 0, 0, n_layers=2))
        gen.add_zero_dofs(i, basis.patch_side_dofs(1, 0, 1, n_layers=2))
        for patch in (0, 1):
            for s in (0, 1):
                gen.add_zero_dofs(
                    i, basis.patch_side_dofs(patch, 1, s, n_layers=2))
    return precompute_shell_reference(
        ExtractedSpline(gen, quad_degree=2 * P, nders=2))


def shell_energy(ctx, u, params):
    return svk_psi_surface(ctx, u, params["E"], params["nu"], params["h"])


def make_coupling(sp, nx):
    h_el = 1.0 / nx
    if CPL == "penalty":
        pd = 1e2 * E_MOD * H_TH / h_el
        pr = 1e2 * E_MOD * H_TH ** 3 / h_el
        print(f"  penalty coupling nel={nx}: pd={pd:.3g} pr={pr:.3g}")
        return ShellInterfaceCoupling(sp, 0, (0, 1), 1, (0, 0),
                                      penalty_disp=pd, penalty_rot=pr)
    D = E_MOD * H_TH ** 3 / 12.0 / (1 - NU ** 2)
    bd = BETA_C * (D / h_el ** 3 + E_MOD * H_TH / h_el)
    br = BETA_C * D / h_el
    print(f"  nitsche coupling nel={nx}: beta_d={bd:.3g} beta_r={br:.3g}")
    return EnergyNitscheCoupling(
        sp, 0, (0, 1), 1, (0, 0), shell_energy, beta_d=bd, beta_r=br,
        w_order=2, params={"E": E_MOD, "nu": NU, "h": H_TH})


def res_adj(ctx, u):
    F = svk_shell_adjoint(ctx, u, E_MOD, NU, H_TH)
    return F._replace(val=F.val.at[2].add(-Q))


def main():
    t0 = time.time()
    sizes = []
    nx, ay, by = NEL, 2 * NEL, 2 * NEL + 4
    while nx >= 8:
        sizes.append((nx, ay, by))
        if nx % 2 or ay % 2 or by % 2:
            break
        nx //= 2
        ay //= 2
        by //= 2
    splines, couplings = [], []
    for (nx, nay, nby) in sizes:
        sp = build(nx, nay, nby)
        splines.append(sp)
        couplings.append(make_coupling(sp, nx))
    spline, coupling = splines[0], couplings[0]
    print(f"preprocess {time.time() - t0:.1f}s ndof={spline.ndof} "
          f"levels={sizes}")

    t0 = time.time()
    ns = MultiPatchStencilNewton(
        spline, res_adj, coupling, mg_splines=splines[1:],
        mg_couplings=couplings[1:], cg_iters=15, polish_cg_iters=40,
        setup_log=print, polish_tangent="f64",
        polish_residual_device="accel",
        build_quad_degree=2, rebuild_rel=0.1)
    print(f"setup {time.time() - t0:.1f}s "
          f"(fine omega scale {ns._fine_omega_scale:.3f})")

    # full solve WITH the f32 production phase
    t0 = time.time()
    Usol, rel, steps, dU_rel = ns.solve(rtol=1e-10, log=print)
    t_solve = time.time() - t0
    r0 = float(jnp.linalg.norm(ns._res(ns.asm64, ns.mask64,
                                       jnp.zeros_like(Usol))))
    if DEV == "cpu":
        other = rel  # same backend; cross-check only meaningful on a GPU
    else:
        other = ns.cpu_true_residual(Usol) / r0
    print(f"SOLVE: {t_solve:.1f}s {steps} steps rel={rel:.3e} "
          f"dU_rel={dU_rel:.2e} cross={other:.3e}")
    print(f"jump_norm={float(coupling.jump_norm(Usol)):.3e}")

    # warm polish step time
    _, rn_p, _ = ns.polish_step(Usol, rebuild=False)
    _ = float(rn_p)
    best = np.inf
    for _ in range(2):
        t0 = time.time()
        _, rn_p, _ = ns.polish_step(Usol, rebuild=False)
        _ = float(rn_p)
        best = min(best, time.time() - t0)
    print(f"warm polish step {best * 1e3:.1f} ms "
          f"({spline.ndof / best:.3e} DoF/s)")

    if os.environ.get("BREAKDOWN", "0") == "1":
        # component timing of the warm polish step: residual vs mixed
        # FCG solve (each forced with a value fetch)
        r64 = ns._res64(Usol)
        _ = float(jnp.linalg.norm(r64))
        tb = np.inf
        for _ in range(3):
            t0 = time.time()
            r64 = ns._res64(Usol)
            _ = float(jnp.linalg.norm(r64))
            tb = min(tb, time.time() - t0)
        print(f"  polish residual: {tb * 1e3:.1f} ms "
              f"(device={ns.polish_residual_device})")
        dU = ns._mixed_solve(ns._st64, ns._st32_frozen, r64)
        _ = float(jnp.vdot(dU, dU))
        tm = np.inf
        for _ in range(3):
            t0 = time.time()
            dU = ns._mixed_solve(ns._st64, ns._st32_frozen, r64)
            _ = float(jnp.vdot(dU, dU))
            tm = min(tm, time.time() - t0)
        print(f"  mixed FCG solve: {tm * 1e3:.1f} ms "
              f"({ns._polish_cg_iters} iters)")
        # single f64 operator apply
        ta = np.inf
        x = dU
        for _ in range(5):
            t0 = time.time()
            x = ns._st64(x)
            _ = float(jnp.vdot(x, x))
            ta = min(ta, time.time() - t0)
        print(f"  one f64 MP-operator apply: {ta * 1e3:.2f} ms")


if __name__ == "__main__":
    main()
