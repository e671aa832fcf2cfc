"""Breakdown of the production Newton step: f32 residual assembly vs
stencil tangent build (jet-Hessian, reduced quadrature) vs fused MG-CG
inner solve.  Sizes the next optimization target (a hand-derived SVK
second variation would attack the build term).

Timing: dependent jitted dispatch chains ending in a host value fetch
(see bench.py).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
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

    nel = int(os.environ.get("BENCH_NEL", "128"))
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

    spline = build(nel)
    mg_sizes = []
    n = nel // 2
    while n >= 8:
        mg_sizes.append(n)
        n //= 2
    mg_splines = [build(s) for s in mg_sizes]

    E_mod, nu, h_th, q = 1.0e7, 0.3, 0.03, 100.0

    def res_adj(ctx, u):
        F = svk_shell_adjoint(ctx, u, E_mod, nu, h_th)
        return F._replace(val=F.val.at[2].add(-q))

    ccache = os.path.join(".tigar_cache",
                          f"bench_coarse_{nel}_p{p}_{E_mod:g}_{nu:g}_"
                          f"{h_th:g}.npz")
    qd = os.environ.get("BENCH_BUILD_QD", "2")
    qd = None if qd in ("", "none") else int(qd)
    hess = None
    if os.environ.get("BENCH_HESS", "0") == "1":
        from tigar_tpu.models.shell import svk_shell_hessian
        hess = lambda ctx, u: svk_shell_hessian(ctx, u, E_mod, nu, h_th)
    ns = StencilNewton(spline, res_adj, mg_splines=mg_splines,
                       cg_iters=15, setup_log=log, coarse_cache=ccache,
                       build_quad_degree=qd, hessian=hess)
    log(f"ndof={spline.ndof} build_quad_degree={qd}")

    rng = np.random.default_rng(0)
    U32 = jnp.asarray(rng.normal(size=spline.ndof) * 1e-4,
                      dtype=jnp.float32)

    def timed(label, fn, rep=10):
        # compile + first
        out = fn(U32, 0)
        jax.tree_util.tree_map(
            lambda x: np.asarray(x) if hasattr(x, "shape") else x, out)
        best = np.inf
        for _ in range(3):
            t0 = time.time()
            acc = None
            for i in range(rep):
                acc = fn(U32, i)
            # force: fetch a scalar from the last output
            leaves = jax.tree_util.tree_leaves(acc)
            float(jnp.sum(leaves[0].ravel()[:1]))
            best = min(best, (time.time() - t0) / rep)
        log(f"{label}: {best * 1e3:.2f} ms")
        return best

    # (a) f32 residual
    def frun(U, i):
        return ns._res(ns.asm32, ns.mask32, U + 1e-9 * i)
    t_res = timed("residual f32", frun)

    # (b) stencil tangent build (reduced quadrature per config)
    def fbuild(U, i):
        return ns._build(ns.asm_b32, U + 1e-9 * i).S
    t_build = timed("tangent stencil build f32", fbuild, rep=5)

    # (c) fused MG-CG inner solve (15 iters), frozen stencil
    st = ns._build(ns.asm_b32, U32)
    b = ns._res(ns.asm32, ns.mask32, U32)

    def fsolve(U, i):
        return ns._inner_solve(st, b + 1e-9 * i)
    t_solve = timed("inner MG-CG (15 it)", fsolve)

    tot = t_res + t_build + t_solve
    log(f"sum: {tot * 1e3:.1f} ms "
        f"(residual {100 * t_res / tot:.0f}% / build "
        f"{100 * t_build / tot:.0f}% / solve {100 * t_solve / tot:.0f}%)")


if __name__ == "__main__":
    main()
