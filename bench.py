"""Benchmark: Kirchhoff-Love SVK shell -- full Newton step + solve.

HEADLINE: wall-clock of one PRODUCTION NEWTON STEP on the KL-shell
workload (BASELINE.json: "assembly + solve throughput on KL-shell"), as
DoF/s, vs a documented model of the reference's Newton step.  The
production step is the mixed-precision path of
solvers/newton_stencil.StencilNewton:

    f32 adjoint-form residual assembly      (no assembly-level AD)
  + f32 stencil tangent build               (pointwise jet-Hessian ->
                                             element matrices ->
                                             sliding-window stencil)
  + geometric-MG-preconditioned CG          (V-cycle over nested
                                             knot-insertion levels)
  + update.

F64 ACCURACY: the same driver's polish phase switches the residual to f64
and reiterates (nonlinear iterative refinement).  The bench runs the FULL
solve (q=100: deflection ~2.7x thickness, genuinely nonlinear) and
certifies convergence two ways: rtol=1e-10 on the f64 relative residual,
OR the DOUBLE-PRECISION EVALUATION FLOOR -- the final device f64 residual
must match an independent host-CPU f64 evaluation of the same state
(within 3x) with a collapsed Newton increment (|dU|/|U| <= 1e-10,
typically ~1e-14).  The floor is intrinsic to ANY f64 assembly of this
4th-order operator at this resolution (both evaluations give ~5e-10 x
|r0|, disagreeing ~30% componentwise -- pure roundoff); the reference's
FEniCS assembly is bound by the same floor.

REFERENCE-STEP MODEL (vs_baseline): the reference assembles an f64
residual AND tangent matrix with FEniCS and LU-factors with PETSc every
step (common.py:1304-1348, default solver 'direct' via dolfin.solve).
Model, deliberately generous to the reference:
  residual assembly at the accepted 1.0e5 DoF/s baseline (BASELINE.md);
  tangent-matrix assembly at 4x the residual cost (the quadrature-loop
  work is nen=27x per entry column; 4x assumes heavy FFC optimization);
  sparse LU at 1.0 s per 50.7k DoFs scaling O(n^1.5) (2D MUMPS).
vs_baseline = t_ref_step / t_step.

TIMING: python-level chains of DEPENDENT jitted dispatches ending in a
host value fetch, so each timer reads completed device work.  The
persistent compilation cache (config.configure_compilation_cache) is
logged so cold/warm compile behavior is visible in the artifact.

Prints ONE COMPACT JSON line to stdout: the headline metric/value/
vs_baseline plus one-number summaries of the sweep / two-patch /
T-spline points; the FULL per-point detail (certificates, phase
timings, interface descriptions, cache stats) is written to
BENCH_DETAILS.json next to this file and referenced by path.
Diagnostics on stderr.
"""

import json
import os
import sys
import time

import numpy as np

CPU_FENICS_ASSEMBLY_DOF_PER_S = 1.0e5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def ref_step_seconds(ndof):
    """Documented reference full-Newton-step model (see module docstring).

    BOUNDED by measurement (round 4, scripts/bench_ref_model.py): a
    same-machine single-core implementation of the same step (XLA:CPU
    f64 residual 2.4e5 DoF/s, sparse tangent assembly, SuperLU) takes
    43.3 s at 50.7k DoFs where this model grants the reference 3.54 s --
    the model is generous by >= 12x (>= 4x on the LU term alone), so
    vs_baseline values computed from it are lower bounds."""
    t_res = ndof / CPU_FENICS_ASSEMBLY_DOF_PER_S
    t_mat = 4.0 * t_res
    t_lu = 1.0 * (ndof / 50700.0) ** 1.5
    return t_res + t_mat + t_lu


def _time_step(ns, spline, log, reps=3):
    """Best-of-reps wall clock of one production Newton step (dependent
    dispatch chain ended by a host value fetch -- see module docstring).
    Logs the compile + first-step seconds."""
    import time
    import jax.numpy as jnp

    U = jnp.zeros(spline.ndof, dtype=spline.dtype)
    t0 = time.time()
    U1, rn, _dU = ns.step(U)
    _ = (float(rn), float(jnp.vdot(U1, U1)))
    log(f"newton step compile+first: {time.time() - t0:.1f}s")
    best = np.inf
    Ui = U1
    for _ in range(reps):
        t0 = time.time()
        Ui, rn, _dU = ns.step(Ui)
        _ = float(jnp.vdot(Ui, Ui))   # fetch forces the whole chain
        best = min(best, time.time() - t0)
    return best


def _solve_and_certify(ns, spline, polish_res_dev, log, use_nested=False,
                       floor_rel=1e-8, **solve_kwargs):
    """Full mixed-precision solve + double-precision floor certificate
    (see main() comments); returns the artifact fragment (the converged
    state is under the non-JSON key "_U").  ``floor_rel``: absolute
    guard on the certified relative residual -- problem-dependent (the
    f64 evaluation floor scales with the largest term in the residual:
    interface penalties at pd ~ 2e9 raise it ~140x over the single-patch
    shell); the BINDING parts of the certificate are the cross-backend
    agreement and the collapsed Newton increment."""
    import time
    import jax.numpy as jnp

    t0 = time.time()
    if use_nested:
        Usol, rel64, nsteps, dU_rel = ns.solve_nested(rtol=1e-10, log=log)
    else:
        Usol, rel64, nsteps, dU_rel = ns.solve(rtol=1e-10, log=log,
                                               **solve_kwargs)
    t_solve = time.time() - t0
    r0_64 = float(jnp.linalg.norm(ns._res(ns.asm64, ns.mask64,
                                          jnp.zeros_like(Usol))))
    # the cross-check evaluation must come from the OTHER f64
    # implementation than the one the solve's own residuals used: host
    # CPU f64 vs device f64
    if polish_res_dev == "cpu":
        cpu_rel = ns.true_rel_residual(Usol, r0_64)   # device
    else:
        cpu_rel = ns.cpu_true_residual(Usol) / r0_64  # host CPU
    log(f"full solve: {t_solve:.2f}s, {nsteps} steps, "
        f"final f64 rel |r| = {rel64:.3e}, |dU|/|U| = {dU_rel:.2e}, "
        f"cross-backend true-f64 rel = {cpu_rel:.3e} "
        f"(polish residuals on {polish_res_dev})")
    # the floor certificate needs BOTH signatures: device and host-CPU
    # evaluations agreeing (at a non-floor state they agree trivially) AND
    # a collapsed Newton increment (only true at the roundoff floor)
    floor_certified = bool(rel64 <= 3.0 * max(cpu_rel, 1e-16)
                           and rel64 <= floor_rel and dU_rel <= 1e-10)
    f64_ok = bool(rel64 <= 1e-10) or floor_certified
    return {
        "full_solve_s": t_solve,
        "full_solve_steps": nsteps,
        "f64_rel_residual": rel64,
        "f64_dU_rel": dU_rel,
        "cross_backend_true_f64_rel_residual": cpu_rel,
        "polish_residual_device": polish_res_dev,
        "f64_floor_certified": floor_certified,
        "f64_accurate": f64_ok,
        "_U": Usol,
    }


def _two_patch_point(log):
    """The PRODUCTION
    mixed-precision solve on a COUPLED TWO-PATCH KL shell -- same plate,
    same material, same load as the headline, but split at x=0 into two
    patches with a NON-MATCHING interface (nel x 2nel vs nel x 2nel+4
    elements).  Solver: solvers/newton_stencil_mp.MultiPatchStencilNewton
    -- per-patch stencil tangents + the exact dense interface block,
    per-patch MG transfers, interface Schwarz smoothing, and the same
    f32-production / f64-polish phases and evaluation-floor certificates
    as the single-patch flagship.

    COUPLING (default): the CONSISTENT symmetric Nitsche derived
    automatically from the shell energy (interface.EnergyNitscheCoupling
    on svk_psi_surface) at moderate stabilization beta_d ~ 10*(D/h^3 +
    E*h/h), beta_r ~ 10*D/h -- ~7.5x below the round-4 displacement
    penalty at nel=64.  This kills the penalty's O(1/beta) consistency
    floor AND its roundoff amplification: the f32 production phase is
    productive again (no start_polish) and the f64 polish reaches the
    ~1e-9-class cross-backend floor with the TIGHT floor_rel guard
    (penalty: floor 7.7e-8, floor_rel relaxed to 1e-6, f32 phase
    abandoned).  BENCH_TP_COUPLING=penalty keeps the round-4 point
    reproducible."""
    import os
    import time
    import numpy as np
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

    p = 2
    nel = int(os.environ.get("BENCH_TP_NEL", "64"))   # per patch along x
    E_mod, nu, h_th = 1.0e7, 0.3, 0.03
    q = float(os.environ.get("BENCH_Q", "100.0"))
    kind = os.environ.get("BENCH_TP_COUPLING", "nitsche")

    def build(nx, nay, nby):
        pa = TensorBSplineBasis(
            [p, p], [uniform_knots(p, 0.0, 1.0, nx),
                     uniform_knots(p, 0.0, 1.0, nay)])
        pb = TensorBSplineBasis(
            [p, p], [uniform_knots(p, 0.0, 1.0, nx),
                     uniform_knots(p, 0.0, 1.0, nby)])
        basis = MultiPatchBSplineBasis([pa, pb])

        def bnet(patch, x_off):
            g = patch.greville_points()
            B = np.zeros((g.shape[0], 4))
            B[:, 0] = g[:, 0] + x_off           # [-1,0] / [0,1]
            B[:, 1] = 2.0 * g[:, 1] - 1.0       # [-1,1]
            B[:, 3] = 1.0
            return B

        cm = MultiPatchControlMesh(
            basis, [bnet(basis.patches[0], -1.0),
                    bnet(basis.patches[1], 0.0)])
        gen = EqualOrderSpline(3, cm)
        for i in range(3):
            gen.add_zero_dofs(i, basis.patch_side_dofs(0, 0, 0, n_layers=2))
            gen.add_zero_dofs(i, basis.patch_side_dofs(1, 0, 1, n_layers=2))
            for patch in (0, 1):
                for s in (0, 1):
                    gen.add_zero_dofs(
                        i, basis.patch_side_dofs(patch, 1, s, n_layers=2))
        return precompute_shell_reference(
            ExtractedSpline(gen, quad_degree=2 * p, nders=2))

    def _shell_energy(ctx, u, params):
        return svk_psi_surface(ctx, u, params["E"], params["nu"],
                               params["h"])

    def make_coupling(sp, nx):
        h_el = 1.0 / nx
        if kind == "penalty":
            pd = 1e2 * E_mod * h_th / h_el
            pr = 1e2 * E_mod * h_th ** 3 / h_el
            return ShellInterfaceCoupling(
                sp, 0, (0, 1), 1, (0, 0), penalty_disp=pd, penalty_rot=pr)
        D = E_mod * h_th ** 3 / 12.0 / (1 - nu ** 2)
        bd = 10.0 * (D / h_el ** 3 + E_mod * h_th / h_el)
        br = 10.0 * D / h_el
        return EnergyNitscheCoupling(
            sp, 0, (0, 1), 1, (0, 0), _shell_energy, beta_d=bd, beta_r=br,
            w_order=2, params={"E": E_mod, "nu": nu, "h": h_th})

    h_el = 1.0 / nel
    pd = 1e2 * E_mod * h_th / h_el
    pr = 1e2 * E_mod * h_th ** 3 / h_el

    t0 = time.time()
    # nested level sizes: knot-insertion transfers need every coarser
    # count to be EXACTLY half the finer one, so the whole triple halves
    # together: (n, 2n, 2n+4) -> (n/2, n, n+2) -> (n/4, n/2, n/2+1)
    sizes = []
    nx, ay, by = nel, 2 * nel, 2 * nel + 4
    while nx >= 16:
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
    log(f"two-patch preprocess: {time.time() - t0:.1f}s; "
        f"ndof={spline.ndof}, levels={sizes}")

    def res_adj(ctx, u):
        F = svk_shell_adjoint(ctx, u, E_mod, nu, h_th)
        return F._replace(val=F.val.at[2].add(-q))

    ccache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          ".tigar_cache",
                          f"bench_tp_coarse_{kind}_{nel}_p{p}_{E_mod:g}_"
                          f"{nu:g}_{h_th:g}_{pd:g}_{pr:g}.npz")
    polish_res_dev = os.environ.get("BENCH_POLISH_RES_DEV", "accel")
    t0 = time.time()
    ns = MultiPatchStencilNewton(
        spline, res_adj, coupling, mg_splines=splines[1:],
        mg_couplings=couplings[1:],
        cg_iters=int(os.environ.get("BENCH_CG_ITERS", "15")),
        polish_cg_iters=40, setup_log=log, coarse_cache=ccache,
        polish_tangent="f64", polish_residual_device=polish_res_dev,
        build_quad_degree=2, rebuild_rel=0.1)
    log(f"two-patch solver setup: {time.time() - t0:.1f}s")

    # COUPLING-DEPENDENT solve mode:
    #   nitsche (default): the f32 production phase RUNS (no
    #     start_polish) -- the consistent coupling's moderate beta does
    #     not amplify the inner f32 solve's eps32*kappa floor into a
    #     rejected step (penalty: rel ~2.9e3 after one step), and the
    #     f64 polish reaches the ~1e-9-class floor, certified with the
    #     TIGHT floor_rel=1e-8 guard.
    #   penalty (round-4 reproduction): POLISH-FIRST (start_polish) --
    #     pd ~ 2e9 amplifies the f32 inner-solve floor; both f64
    #     evaluations floor at ~7e-8 rel (floor_rel relaxed to 1e-6; the
    #     certificate's binding parts remain the cross-backend agreement
    #     + the collapsed increment).
    step32_s = _time_step(ns, spline, log, reps=2)
    if kind == "penalty":
        out = _solve_and_certify(ns, spline, polish_res_dev, log,
                                 floor_rel=1e-6, start_polish=True)
    else:
        out = _solve_and_certify(ns, spline, polish_res_dev, log,
                                 floor_rel=1e-8)
    Usol = out.pop("_U")
    t0 = time.time()
    _, rn_p, _dU = ns.polish_step(Usol, rebuild=False)
    _ = float(rn_p)
    step_s = time.time() - t0
    for _ in range(2):
        t0 = time.time()
        _, rn_p, _dU = ns.polish_step(Usol, rebuild=False)
        _ = float(rn_p)
        step_s = min(step_s, time.time() - t0)
    if kind == "penalty":
        iface_desc = ("non-matching, displacement+rotation penalty "
                      f"(pd={pd:g}, pr={pr:g})")
        phases = ("polish-first mixed precision (f64 residual + "
                  "f32-V-cycle FCG); f32 production steps are "
                  "penalty-noise-bound at this pd")
    else:
        D = E_mod * h_th ** 3 / 12.0 / (1 - nu ** 2)
        bd = 10.0 * (D / h_el ** 3 + E_mod * h_th / h_el)
        iface_desc = ("non-matching, consistent energy-derived symmetric "
                      f"Nitsche (beta_d={bd:g}, beta_r={10.0 * D / h_el:g})")
        phases = ("full production: f32 Newton steps + f64 polish "
                  "(consistent coupling at moderate beta -- no penalty "
                  "noise floor)")
    out.update({
        "ndof": spline.ndof,
        "nel": sum(nx * nay + nx * nby for nx, nay, nby in sizes[:1]),
        "patches": 2,
        "coupling": kind,
        "interface": iface_desc,
        "solve_phases": phases,
        "newton_step_ms": step_s * 1e3,
        "newton_step_dof_per_s": spline.ndof / step_s,
        "f32_step_ms": step32_s * 1e3,
        "vs_baseline": ref_step_seconds(spline.ndof) / step_s,
    })
    log(f"two-patch ({kind}): polish step {step_s * 1e3:.1f} ms "
        f"({spline.ndof / step_s:.3e} DoF/s; f32 step "
        f"{step32_s * 1e3:.1f} ms), solve "
        f"{out['full_solve_s']:.1f}s/{out['full_solve_steps']} steps, "
        f"floor_certified={out['f64_floor_certified']}")
    return out


def _build_tspline_solver(nel, log, polish_res_dev="accel"):
    """The valence-3 extraordinary-point ("star") T-spline KL shell of
    models/tsplines.make_star_extraction (~3*nel^2 elements; no
    tensor-product stencil/MG path can represent it) and its SANewton.
    Returns (spline, solver)."""
    import os
    import tempfile
    import time

    from tigar_tpu.models.tsplines import (make_star_extraction,
                                           write_rhino_extraction,
                                           RhinoTSplineControlMesh)
    from tigar_tpu.models.space import EqualOrderSpline
    from tigar_tpu.models.extracted import ExtractedSpline
    from tigar_tpu.models.shell import (precompute_shell_reference,
                                        svk_shell_adjoint)
    from tigar_tpu.solvers.newton_sa import SANewton

    E_mod, nu, h_th = 3.0e4, 0.3, 0.03
    # clamped-plate scale: deflection ~2.7x thickness at q=0.4 (genuinely
    # nonlinear, same class as the single-patch headline at q=100)
    q = float(os.environ.get("BENCH_TS_Q", "0.4"))

    t0 = time.time()
    bnet, nodes_list, ops_list = make_star_extraction(3, nel)
    with tempfile.TemporaryDirectory() as tmp:
        fpath = os.path.join(tmp, "star.iga")
        write_rhino_extraction(fpath, bnet, nodes_list, ops_list)
        cm = RhinoTSplineControlMesh(fpath)
    gen = EqualOrderSpline(3, cm)
    bd = cm.scalar_basis().boundary_dofs(1)
    for i in range(3):
        gen.add_zero_dofs(i, bd)
    spline = precompute_shell_reference(
        ExtractedSpline(gen, quad_degree=6, nders=2))
    log(f"t-spline preprocess: {time.time() - t0:.1f}s; "
        f"ndof={spline.ndof} (star valence 3, nel/sector {nel})")

    def res_adj(ctx, u):
        F = svk_shell_adjoint(ctx, u, E_mod, nu, h_th)
        return F._replace(val=F.val.at[2].add(-q))

    t0 = time.time()
    ns = SANewton(spline, res_adj,
                  cg_iters=int(os.environ.get("BENCH_TS_CG_ITERS", "120")),
                  polish_cg_iters=int(os.environ.get("BENCH_TS_PCG_ITERS",
                                                     "160")),
                  setup_log=log, polish_tangent="f64",
                  polish_residual_device=polish_res_dev,
                  build_quad_degree=4, rebuild_rel=0.1,
                  sa_kwargs={"near_kernel": "linear"})
    log(f"t-spline SANewton setup: {time.time() - t0:.1f}s")
    return spline, ns


def _tspline_point(log):
    """The space-agnostic third Newton tier (solvers/newton_sa.SANewton
    -- element-batch tangent + multilevel smoothed-aggregation V-cycle)
    on the device, driving the KL shell on the star T-spline of
    _build_tspline_solver.  Measures the warm f32 production step, the
    warm f64 polish step, and the full mixed-precision solve with the
    same cross-backend floor certificate as the other points.  Size via
    BENCH_TS_NEL (elements per sector edge; default 48 -> ~3*48^2
    elements)."""
    import os
    import time
    import numpy as np

    nel = int(os.environ.get("BENCH_TS_NEL", "48"))
    polish_res_dev = os.environ.get("BENCH_POLISH_RES_DEV", "accel")
    spline, ns = _build_tspline_solver(nel, log, polish_res_dev)

    step32_s = _time_step(ns, spline, log, reps=2)
    out = _solve_and_certify(ns, spline, polish_res_dev, log)
    Usol = out.pop("_U")
    _, rn_p, _dU = ns.polish_step(Usol, rebuild=False)
    _ = float(rn_p)
    step_s = np.inf
    for _ in range(2):
        t0 = time.time()
        _, rn_p, _dU = ns.polish_step(Usol, rebuild=False)
        _ = float(rn_p)
        step_s = min(step_s, time.time() - t0)
    out.update({
        "ndof": spline.ndof,
        "space": f"star T-spline (valence-3 extraordinary point), "
                 f"{nel}/sector",
        "solver": "SANewton (element-batch tangent + multilevel-SA "
                  "V-cycle)",
        "newton_step_ms": step_s * 1e3,
        "newton_step_dof_per_s": spline.ndof / step_s,
        "f32_step_ms": step32_s * 1e3,
        "vs_baseline": ref_step_seconds(spline.ndof) / step_s,
    })
    log(f"t-spline: polish step {step_s * 1e3:.1f} ms "
        f"({spline.ndof / step_s:.3e} DoF/s; f32 step "
        f"{step32_s * 1e3:.1f} ms), solve "
        f"{out['full_solve_s']:.1f}s/{out['full_solve_steps']} steps, "
        f"floor_certified={out['f64_floor_certified']}")
    return out


def _build_solver(nel, log, polish_res_dev=None, coarse_cache=True):
    """Build the KL-shell spline hierarchy + production StencilNewton at
    one size (options identical at every size except the measured
    cast-vs-f64 polish-tangent switch).  ``polish_res_dev`` defaults to
    BENCH_POLISH_RES_DEV (else the device); ``coarse_cache`` keeps the
    zero-state coarse ladder in a .npz under .tigar_cache keyed by the
    discretization+material (False: build it on the device in this
    process).  Logs the preprocess and solver
    set-up seconds; returns (spline, solver, info) with the set-up
    seconds in info."""
    import os
    import time

    from tigar_tpu.ops.knots import uniform_knots
    from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
    from tigar_tpu.models.space import EqualOrderSpline
    from tigar_tpu.models.extracted import ExtractedSpline
    from tigar_tpu.models.shell import (precompute_shell_reference,
                                        svk_shell_adjoint)
    from tigar_tpu.solvers.newton_stencil import StencilNewton

    p = 2

    def build(n):
        kvecs = [uniform_knots(p, -1.0, 1.0, n)] * 2
        cm = ExplicitBSplineControlMesh([p, p], kvecs, extra_dim=1)
        sp = EqualOrderSpline(3, cm)
        basis = cm.scalar_basis()
        for side in (0, 1):
            for direction in (0, 1):
                dofs = basis.side_dofs(direction, side, n_layers=2)
                for i in range(3):
                    sp.add_zero_dofs(i, dofs)
        return precompute_shell_reference(
            ExtractedSpline(sp, quad_degree=2 * p, nders=2))

    t_pre0 = time.time()
    spline = build(nel)
    mg_sizes = []
    n = nel // 2
    while n >= 8:
        mg_sizes.append(n)
        n //= 2
    mg_splines = [build(s) for s in mg_sizes]
    t_pre = time.time() - t_pre0
    log(f"preprocess: {t_pre:.1f}s; ndof={spline.ndof}, "
        f"nel={nel}^2, mg levels={[nel] + mg_sizes}")

    # q=100 deflects the plate ~2.7x its thickness: a genuinely nonlinear
    # membrane-stiffening regime (multiple productive f32 Newton steps),
    # and a residual scale ~1e4 larger than q=1e-2, pushing the RELATIVE
    # double-precision evaluation floor (absolute ~1e-9 here, checked
    # against an independent host-CPU f64 evaluation) down to ~1e-10.
    E_mod, nu, h_th = 1.0e7, 0.3, 0.03
    q = float(os.environ.get("BENCH_Q", "100.0"))

    def res_adj(ctx, u):
        F = svk_shell_adjoint(ctx, u, E_mod, nu, h_th)
        return F._replace(val=F.val.at[2].add(-q))

    cg_iters = int(os.environ.get("BENCH_CG_ITERS", "15"))
    # Production solver options (all measured on the solve's
    # convergence; scripts/bench_nested.py is the harness):
    #   build_quad_degree=2: tangent stencils from a 2-point Gauss rule
    #     (the Newton operator only needs SPD-ish accuracy; quadrature
    #     error is a smooth perturbation) -- build cost drops ~9/4.
    #   rebuild_rel=0.1: with qd2 tangents the per-step contraction is
    #     quadrature-limited (~5-8x/step) whether fresh or frozen, so
    #     freeze right after the nonlinear transient.
    #   polish_tangent: "cast" (f32-assembled stencil cast to f64) at
    #     128^2 -- eps32 value noise is harmless at this kappa and the
    #     f64 tangent build disappears; "f64" at 256^2+ where kappa~n^4
    #     amplification of the cast noise collapses Newton contraction to
    #     0.65/step.  Whether "cast" still pays with native f64 is a
    #     measured question.
    #   polish_residual_device: "accel" evaluates the polish residuals on
    #     the device; "cpu" on the host (the floor certificate then
    #     cross-checks against the device evaluation).
    polish_tangent = "cast" if nel <= 128 else "f64"
    if polish_res_dev is None:
        polish_res_dev = os.environ.get("BENCH_POLISH_RES_DEV", "accel")
    ccache = (os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ".tigar_cache",
                           f"bench_coarse_{nel}_p{p}_{E_mod:g}_{nu:g}_"
                           f"{h_th:g}.npz") if coarse_cache else None)
    t0 = time.time()
    ns = StencilNewton(spline, res_adj, mg_splines=mg_splines,
                       cg_iters=cg_iters, setup_log=log,
                       coarse_cache=ccache,
                       polish_tangent=polish_tangent,
                       polish_residual_device=polish_res_dev,
                       build_quad_degree=2, rebuild_rel=0.1)
    t_setup = time.time() - t0
    log(f"solver setup (coarse ladder): {t_setup:.1f}s")
    return spline, ns, dict(mg_sizes=mg_sizes, q=q, cg_iters=cg_iters,
                            polish_res_dev=polish_res_dev,
                            preprocess_s=t_pre, setup_s=t_setup)


def main():
    T0 = time.time()
    import jax
    from tigar_tpu.config import configure_compilation_cache
    cache_dir = configure_compilation_cache()
    have_cache = os.path.isdir(cache_dir)
    n_cache0 = len(os.listdir(cache_dir)) if have_cache else 0
    log(f"persistent cache: {'present' if have_cache else 'COLD'} "
        f"({n_cache0} entries)")
    import jax.numpy as jnp

    log("devices:", jax.devices())
    nel = int(os.environ.get("BENCH_NEL", "128"))

    spline, ns, info = _build_solver(nel, log)
    mg_sizes = info["mg_sizes"]
    q = info["q"]
    cg_iters = info["cg_iters"]
    polish_res_dev = info["polish_res_dev"]
    if os.environ.get("BENCH_SETUP_ONLY"):
        return

    # ---- assembly rates (diagnostic) ----------------------------------------
    def time_chain(fn, args_maker, rep, label):
        c = jnp.zeros((), jnp.float32)
        t0 = time.time()
        c = fn(*args_maker(c))
        float(c)
        log(f"  {label} compile+first: {time.time() - t0:.1f}s")
        best = np.inf
        for trial in range(2):
            c = jnp.asarray(float(trial), c.dtype)
            t0 = time.time()
            for _ in range(rep):
                c = fn(*args_maker(c))
            float(c)
            best = min(best, (time.time() - t0) / rep)
        return best

    def res_probe(asm_, mask, U, c):
        # perturb/reduce EAGERLY (tiny dispatches) around the solver's own
        # jitted residual program, so timing reuses the exact compiled
        # artifact the production step runs (one compile, not two)
        Up = U + (1e-9 * c).astype(U.dtype)
        r = ns._res(asm_, mask, Up)
        return (jnp.vdot(r, r) * 1e-30).astype(jnp.float32)

    rng = np.random.default_rng(0)
    U64 = jnp.asarray(rng.normal(size=spline.ndof) * 1e-4)
    U32 = U64.astype(jnp.float32)
    dt32 = time_chain(res_probe,
                      lambda c: (ns.asm32, ns.mask32, U32, c),
                      int(os.environ.get("BENCH_REPS", "20")),
                      "residual f32")
    log(f"residual assembly f32: {dt32 * 1e3:.3f} ms "
        f"({spline.ndof / dt32:.3e} DoF/s)")
    dt64 = time_chain(res_probe,
                      lambda c: (ns.asm64, ns.mask64, U64, c), 5,
                      "residual f64")
    log(f"residual assembly f64: {dt64 * 1e3:.3f} ms "
        f"({spline.ndof / dt64:.3e} DoF/s)")

    # ---- production Newton step (HEADLINE) ----------------------------------
    best_step = _time_step(ns, spline, log, reps=3)
    step_dof_s = spline.ndof / best_step
    t_ref = ref_step_seconds(spline.ndof)
    vsb = t_ref / best_step
    log(f"production newton step: {best_step * 1e3:.1f} ms "
        f"({step_dof_s:.3e} DoF/s; reference model {t_ref:.2f}s -> "
        f"{vsb:.1f}x)")

    # ---- full mixed-precision solve with f64-accuracy check -----------------
    # Convergence is certified two ways: (i) the f64 relative residual
    # against rtol=1e-10, and (ii) when the solve instead hits the
    # DOUBLE-PRECISION EVALUATION FLOOR of the residual (any f64 assembly
    # of a 4th-order operator at this resolution has an absolute roundoff
    # floor ~eps64 * |d2N| * energy scale), a cross-check that a true
    # IEEE-f64 CPU evaluation of the SAME state measures the same floor
    # -- i.e. no double-precision code, the reference's FEniCS assembly
    # included, could verify a smaller residual.
    # Nested iteration (solve_nested: coarse-level solve + exact
    # prolongation) is available via BENCH_NESTED=1 but is NOT the
    # production path at any measured size: the tuned flat solve beats
    # it everywhere (256^2: flat 116.9s vs nested_rebuild 382.8s --
    # the coarse stage's own f64 polish steps cost more than the fine
    # transient they skip; chord-only coarse stages stall at q=100).
    use_nested = os.environ.get("BENCH_NESTED", "0") == "1"
    solve_out = _solve_and_certify(ns, spline, polish_res_dev, log,
                                   use_nested=use_nested)
    t_solve = solve_out["full_solve_s"]
    nsteps = solve_out["full_solve_steps"]
    rel64 = solve_out["f64_rel_residual"]
    dU_rel = solve_out["f64_dU_rel"]
    cpu_rel = solve_out["cross_backend_true_f64_rel_residual"]
    floor_certified = solve_out["f64_floor_certified"]
    f64_ok = solve_out["f64_accurate"]
    solve_out.pop("_U", None)

    # free the headline solver's device arrays BEFORE the sweep builds a
    # 4x-larger one (stencil levels + assemblers + caches from the 128^2
    # run otherwise crowd the device memory during the 256^2 builds).
    headline_ndof = spline.ndof
    import gc
    del ns, spline
    gc.collect()

    # ---- scaling sweep: carry the larger-size
    # full-solve + step point in the SAME artifact.  Default: one 256^2
    # point (199k DoFs) when the headline ran at its default 128^2.
    sweep = []
    sweep_nels = os.environ.get("BENCH_SWEEP",
                                "256" if nel == 128 else "")
    for s_nel in [int(x) for x in sweep_nels.split(",") if x.strip()]:
        if s_nel == nel:
            continue
        log(f"--- sweep size {s_nel}^2 ---")
        sp_s, ns_s, info_s = _build_solver(s_nel, log)
        step_s = _time_step(ns_s, sp_s, log, reps=2)
        out_s = _solve_and_certify(ns_s, sp_s, info_s["polish_res_dev"],
                                   log)
        out_s.pop("_U", None)
        out_s.update({
            "nel": s_nel * s_nel,
            "ndof": sp_s.ndof,
            "newton_step_ms": step_s * 1e3,
            "newton_step_dof_per_s": sp_s.ndof / step_s,
            "vs_baseline": ref_step_seconds(sp_s.ndof) / step_s,
        })
        log(f"sweep {s_nel}^2: step {step_s * 1e3:.1f} ms "
            f"({sp_s.ndof / step_s:.3e} DoF/s), solve "
            f"{out_s['full_solve_s']:.1f}s, floor_certified="
            f"{out_s['f64_floor_certified']}")
        sweep.append(out_s)
        del sp_s, ns_s
        gc.collect()

    # ---- coupled two-patch production solve ---------------------------------
    two_patch = None
    if os.environ.get("BENCH_TWO_PATCH",
                      "1" if nel == 128 else "0") == "1":
        log("--- coupled two-patch shell ---")
        two_patch = _two_patch_point(log)

    # ---- SANewton star-T-spline point ---------------------------------------
    tspline = None
    if os.environ.get("BENCH_TSPLINE",
                      "1" if nel == 128 else "0") == "1":
        log("--- star-T-spline SANewton shell ---")
        tspline = _tspline_point(log)

    n_cache1 = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    log(f"persistent cache: {n_cache1 - n_cache0} new entries "
        f"(misses); {n_cache1} total")

    # FULL details -> BENCH_DETAILS.json (referenced by path from the
    # compact stdout line).
    details_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "BENCH_DETAILS.json")
    details = {
        "headline": {
            "ndof": headline_ndof,
            "nel": nel * nel,
            "newton_step_ms": best_step * 1e3,
            "ref_step_model_s": t_ref,
            "ref_step_model": "residual@1e5 DoF/s + 4x tangent matrix + "
                              "O(n^1.5) LU (1s@50.7k); see bench.py "
                              "docstring",
            "full_solve_nested": use_nested,
            "load_q": q,
            "residual_assembly_f32_ms": dt32 * 1e3,
            "residual_assembly_f32_dof_per_s": headline_ndof / dt32,
            "residual_assembly_f64_ms": dt64 * 1e3,
            "mg_levels": [nel] + mg_sizes,
            "cg_iters": cg_iters,
            **{k: v for k, v in solve_out.items()},
        },
        "sweep": sweep,
        "two_patch": two_patch,
        "tspline": tspline,
        "cache_new_entries": n_cache1 - n_cache0,
        "timing": "dependent jitted dispatch chains + host value "
                  "fetch (bench.py docstring)",
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "wall_s": time.time() - T0,
    }
    with open(details_path, "w") as f:
        json.dump(details, f, indent=1)
    log(f"details -> {details_path}")

    def _pt(d, *keys):
        """Compact per-point summary for the stdout line."""
        if d is None:
            return None
        out = {"ndof": d.get("ndof"),
               "step_ms": round(d.get("newton_step_ms", 0.0), 1),
               "vs_baseline": round(d.get("vs_baseline", 0.0), 1),
               "floor_certified": d.get("f64_floor_certified")}
        for k in keys:
            out[k] = d.get(k)
        return out

    print(json.dumps({
        "metric": "kl_shell_newton_step_dof_per_s",
        "value": round(step_dof_s, 1),
        "unit": "dof/s",
        "vs_baseline": round(vsb, 2),
        "extra": {
            "ndof": headline_ndof,
            "newton_step_ms": round(best_step * 1e3, 2),
            "full_solve_s": round(t_solve, 1),
            "full_solve_steps": nsteps,
            "f64_rel_residual": float(f"{rel64:.3g}"),
            "f64_floor_certified": floor_certified,
            "f64_accurate": f64_ok,
            "sweep": [_pt(s) for s in sweep],
            "two_patch": _pt(two_patch, "coupling"),
            "tspline": _pt(tspline, "space"),
            "details": "BENCH_DETAILS.json",
        },
    }))
    if not f64_ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
