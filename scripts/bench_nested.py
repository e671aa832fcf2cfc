"""Measure nested iteration (StencilNewton.solve_nested) vs the flat
from-zero mixed-precision solve on the bench shell workload.

Usage:  python scripts/bench_nested.py [nel] [mode]
  nel   : fine resolution (default 128)
  mode  : "chord" (coarse stage frozen zero-state stencil: no coarse
          tangent builds), "rebuild" (full coarse Newton), or "both"
Prints timings + step counts for flat vs nested on stderr.
"""

import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from tigar_tpu.config import configure_compilation_cache
    configure_compilation_cache()
    import jax.numpy as jnp

    from tigar_tpu.ops.knots import uniform_knots
    from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
    from tigar_tpu.models.space import EqualOrderSpline
    from tigar_tpu.models.extracted import ExtractedSpline
    from tigar_tpu.models.shell import (precompute_shell_reference,
                                        svk_shell_adjoint)
    from tigar_tpu.solvers.newton_stencil import StencilNewton

    nel = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    mode = sys.argv[2] if len(sys.argv) > 2 else "chord"
    p = 2
    E_mod, nu, h_th, q = 1.0e7, 0.3, 0.03, 100.0

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

    def res_adj(ctx, u):
        F = svk_shell_adjoint(ctx, u, E_mod, nu, h_th)
        return F._replace(val=F.val.at[2].add(-q))

    t0 = time.time()
    spline = build(nel)
    mg_sizes = []
    n = nel // 2
    while n >= 8:
        mg_sizes.append(n)
        n //= 2
    mg_splines = [build(s) for s in mg_sizes]
    log(f"preprocess {time.time() - t0:.1f}s ndof={spline.ndof}")

    ccache = os.path.join(root, ".tigar_cache",
                          f"bench_coarse_{nel}_p{p}_{E_mod:g}_{nu:g}_"
                          f"{h_th:g}.npz")
    t0 = time.time()
    polish_cg = int(os.environ.get("BENCH_POLISH_CG", "30"))
    tangent = os.environ.get("BENCH_POLISH_TANGENT", "f64")
    bqd = os.environ.get("BENCH_BUILD_QD")
    bqd = None if bqd is None else int(bqd)
    rrel = float(os.environ.get("BENCH_REBUILD_REL", "1e-5"))
    ns = StencilNewton(spline, res_adj, mg_splines=mg_splines,
                       cg_iters=15, setup_log=log, coarse_cache=ccache,
                       polish_cg_iters=polish_cg, polish_tangent=tangent,
                       build_quad_degree=bqd, rebuild_rel=rrel)
    log(f"setup {time.time() - t0:.1f}s (polish_cg_iters={polish_cg}, "
        f"polish_tangent={tangent}, build_quad_degree={bqd}, "
        f"rebuild_rel={rrel})")

    results = {}
    # mode: comma-separated subset of {flat, chord, rebuild} or "both"
    # (= flat,chord,rebuild); run order matters through the compile cache,
    # so single-mode runs give the honest fresh-process numbers
    sel = (("flat", "chord", "rebuild") if mode == "both"
           else tuple(mode.split(",")))
    runs = []
    if "flat" in sel:
        runs.append(("flat", dict()))
    if "chord" in sel:
        runs.append(("nested_chord", dict(coarse_chord=True)))
    if "rebuild" in sel:
        runs.append(("nested_rebuild", dict(coarse_chord=False)))
    for name, kw in runs:
        t0 = time.time()
        if name == "flat":
            U, rel, nsteps, dU_rel = ns.solve(rtol=1e-10, log=log)
        else:
            U, rel, nsteps, dU_rel = ns.solve_nested(rtol=1e-10, log=log,
                                                     **kw)
        dt = time.time() - t0
        cpu_rel = None
        try:
            r0_64 = float(jnp.linalg.norm(ns._res(
                ns.asm64, ns.mask64, jnp.zeros_like(U))))
            cpu_rel = ns.cpu_true_residual(U) / r0_64
        except Exception as e:
            log("cpu check failed:", e)
        results[name] = (dt, nsteps, rel, dU_rel, cpu_rel)
        log(f"== {name}: {dt:.1f}s, {nsteps} steps, rel={rel:.3e}, "
            f"|dU|/|U|={dU_rel:.2e}, cpu_rel={cpu_rel}")
    for name, r in results.items():
        log("RESULT", nel, name, r)


if __name__ == "__main__":
    main()
