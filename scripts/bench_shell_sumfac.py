"""Compare SVK shell residual assembly: generic tabulated DomainAssembler
vs sum-factorized SumfacAssembler (ops/sumfac_forms.py): dependent
dispatch chains ending in a value fetch (bench.py docstring).  No H100
measurement recorded yet.

Usage: python scripts/bench_shell_sumfac.py   [BENCH_NEL / BENCH_REPS env]
"""

import os
import sys
import time
from functools import partial

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    from tigar_tpu.config import configure_compilation_cache
    configure_compilation_cache()
    import jax.numpy as jnp
    import jax.tree_util as jtu

    from tigar_tpu.ops.knots import uniform_knots
    from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
    from tigar_tpu.models.space import EqualOrderSpline
    from tigar_tpu.models.extracted import ExtractedSpline
    from tigar_tpu.models.shell import (svk_psi_surface,
                                        precompute_shell_reference,
                                        shell_reference)
    from tigar_tpu.forms import deriv
    from tigar_tpu.ops.sumfac_forms import make_sumfac_assembler

    nel = int(os.environ.get("BENCH_NEL", "128"))
    rep = int(os.environ.get("BENCH_REPS", "20"))
    p = 2
    cm = ExplicitBSplineControlMesh(
        [p, p], [uniform_knots(p, -1.0, 1.0, nel)] * 2, extra_dim=1)
    sp = EqualOrderSpline(3, cm)
    basis = cm.scalar_basis()
    for side in (0, 1):
        for direction in (0, 1):
            dofs = basis.side_dofs(direction, side, n_layers=2)
            for i in range(3):
                sp.add_zero_dofs(i, dofs)
    spline = precompute_shell_reference(
        ExtractedSpline(sp, quad_degree=2 * p, nders=2))
    log(f"nel={nel}^2 ndof={spline.ndof}")

    E_mod, nu, h_th, q = 1.0e7, 0.3, 0.03, 1.0e-2

    def res(ctx, u, v):
        dW = deriv(lambda y: svk_psi_surface(ctx, y, E_mod, nu, h_th), u, v)
        return dW - q * v.val[2]

    asm_gen = spline._assembler("dx")
    asm_sf = make_sumfac_assembler(spline)
    # same shell-reference precompute for the sumfac ctx (flat NQ layout)
    ref = jax.jit(jax.vmap(shell_reference))(asm_sf.ctx)
    aux = dict(asm_sf.ctx.aux or {})
    aux["shell_ref"] = ref
    asm_sf.ctx = asm_sf.ctx._replace(aux=aux)

    def to32(asm):
        return jtu.tree_map(
            lambda x: x.astype(jnp.float32)
            if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
            else x, asm)

    @partial(jax.jit, static_argnames=("rep",))
    def chained(asm_, U, c, rep):
        def body(carry, _):
            r = asm_.residual_vector(res, U + jnp.asarray(1e-9, U.dtype)
                                     * carry)
            return (jnp.vdot(r, r) * 1e-30).astype(carry.dtype), None
        return jax.lax.scan(body, c, None, length=rep)[0]

    rng = np.random.default_rng(0)
    U64 = jnp.asarray(rng.normal(size=spline.ndof) * 1e-4)

    # correctness cross-check first (f64, one shot, JITTED: eager assembly
    # dispatches per primitive)
    @jax.jit
    def _xcheck(ga, sa, U):
        r_gen = ga.residual_vector(res, U)
        r_sf = sa.residual_vector(res, U)
        return jnp.max(jnp.abs(r_gen - r_sf)), jnp.max(jnp.abs(r_gen))
    t0 = time.time()
    dmax_, refm_ = _xcheck(asm_gen, asm_sf, U64)
    dmax, ref_mag = float(dmax_), float(refm_)
    log(f"xcheck {time.time() - t0:.1f}s: max |generic - sumfac| = "
        f"{dmax:.3e} (rel {dmax / ref_mag:.3e})")
    assert dmax < 1e-9 * max(ref_mag, 1e-30)

    results = {}
    for name, asm_, dtype, r in (
            ("generic_f32", to32(asm_gen), jnp.float32, rep),
            ("sumfac_f32", to32(asm_sf), jnp.float32, rep),
            ("generic_f64", asm_gen, jnp.float64, max(2, rep // 8)),
            ("sumfac_f64", asm_sf, jnp.float64, max(2, rep // 8))):
        U = U64.astype(dtype)
        c0 = jnp.zeros((), dtype)
        t0 = time.time()
        float(chained(asm_, U, c0, r))
        log(f"{name}: compile+first {time.time() - t0:.1f}s")
        best = np.inf
        for i in range(2):
            t0 = time.time()
            float(chained(asm_, U, c0 + i, r))
            best = min(best, (time.time() - t0) / r)
        results[name] = best
        log(f"{name}: {best * 1e3:.3f} ms ({spline.ndof / best:.3e} DoF/s)")

    log("speedup f32:", results["generic_f32"] / results["sumfac_f32"])
    log("speedup f64:", results["generic_f64"] / results["sumfac_f64"])


if __name__ == "__main__":
    main()
