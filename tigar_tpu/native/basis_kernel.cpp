// Batched B-spline basis evaluation with derivatives (Cox-de Boor /
// NURBS-book A2.3).
//
// Counterpart of the reference's single native component: the inline C++
// basisFuncsInner kernel JIT-compiled through dolfin/pybind11
// (tIGAr/BSplines.py:48-131), which evaluates ONE parametric point per
// call because the FE-node loop was the preprocessing bottleneck.  Here the
// kernel is batched over arrays of points (OpenMP across points) and also
// returns derivatives to arbitrary order, since the JAX framework needs
// parametric gradients/Hessians of the spline basis explicitly.
//
// Built with: g++ -O3 -fPIC -shared -fopenmp (see build.py); loaded via
// ctypes (ops/native.py) with a vectorized numpy fallback.

#include <cstring>
#include <vector>

extern "C" {

// ghost_knots : [nknots + 2*n_ghost]
// u, span     : [n]  (span in unpadded indexing: u in [U[span], U[span+1]))
// out         : [n, nders+1, p+1]
void bspline_basis_ders(const double* ghost_knots, long n_ghost, long p,
                        const double* u, const long* span, long n,
                        long nders, double* out) {
    const long m = p + 1;
    const long kmax = nders < p ? nders : p;

#pragma omp parallel
    {
        std::vector<double> ndu_v(m * m), left_v(m), right_v(m),
            a_v(2 * m);
        double* ndu = ndu_v.data();
        double* left = left_v.data();
        double* right = right_v.data();
        double* a = a_v.data();

#pragma omp for schedule(static)
        for (long t = 0; t < n; ++t) {
            const double uu = u[t];
            const long i = span[t] + n_ghost;  // padded index
            double* o = out + t * (nders + 1) * m;
            std::memset(o, 0, sizeof(double) * (nders + 1) * m);

            ndu[0] = 1.0;
            for (long j = 1; j <= p; ++j) {
                left[j] = uu - ghost_knots[i + 1 - j];
                right[j] = ghost_knots[i + j] - uu;
                double saved = 0.0;
                for (long r = 0; r < j; ++r) {
                    // lower triangle: knot differences
                    ndu[j * m + r] = right[r + 1] + left[j - r];
                    const double denom = ndu[j * m + r];
                    const double temp =
                        denom != 0.0 ? ndu[r * m + (j - 1)] / denom : 0.0;
                    ndu[r * m + j] = saved + right[r + 1] * temp;
                    saved = left[j - r] * temp;
                }
                ndu[j * m + j] = saved;
            }
            for (long q = 0; q <= p; ++q) o[q] = ndu[q * m + p];
            if (kmax == 0) continue;

            for (long r = 0; r <= p; ++r) {
                long s1 = 0, s2 = 1;
                std::memset(a, 0, sizeof(double) * 2 * m);
                a[0] = 1.0;
                for (long k = 1; k <= kmax; ++k) {
                    double d = 0.0;
                    const long rk = r - k;
                    const long pk = p - k;
                    if (r >= k) {
                        const double denom = ndu[(pk + 1) * m + rk];
                        a[s2 * m + 0] =
                            denom != 0.0 ? a[s1 * m + 0] / denom : 0.0;
                        d = a[s2 * m + 0] * ndu[rk * m + pk];
                    }
                    const long j1 = rk >= -1 ? 1 : -rk;
                    const long j2 = (r - 1) <= pk ? k - 1 : p - r;
                    for (long j = j1; j <= j2; ++j) {
                        const double denom = ndu[(pk + 1) * m + rk + j];
                        a[s2 * m + j] =
                            denom != 0.0
                                ? (a[s1 * m + j] - a[s1 * m + j - 1]) / denom
                                : 0.0;
                        d += a[s2 * m + j] * ndu[(rk + j) * m + pk];
                    }
                    if (r <= pk) {
                        const double denom = ndu[(pk + 1) * m + r];
                        a[s2 * m + k] =
                            denom != 0.0 ? -a[s1 * m + k - 1] / denom : 0.0;
                        d += a[s2 * m + k] * ndu[r * m + pk];
                    }
                    o[k * m + r] = d;
                    const long tmp = s1; s1 = s2; s2 = tmp;
                }
            }
            double fac = (double)p;
            for (long k = 1; k <= kmax; ++k) {
                for (long q = 0; q <= p; ++q) o[k * m + q] *= fac;
                fac *= (double)(p - k);
            }
        }
    }
}

// Batched T-spline tabulation: N[e,q,a] = sum_b C[e,a,b] * Bern[q,b]
// (the unstructured-extraction hot loop; RhinoTSplines.py:37-60 evaluates
// this pointwise in Python).
void extraction_apply(const double* C, const double* bern, long nel,
                      long nshl, long nbern, long nq, double* out) {
#pragma omp parallel for schedule(static)
    for (long e = 0; e < nel; ++e) {
        const double* Ce = C + e * nshl * nbern;
        double* oe = out + e * nq * nshl;
        for (long q = 0; q < nq; ++q) {
            const double* bq = bern + q * nbern;
            for (long a = 0; a < nshl; ++a) {
                const double* Ca = Ce + a * nbern;
                double s = 0.0;
                for (long b = 0; b < nbern; ++b) s += Ca[b] * bq[b];
                oe[q * nshl + a] = s;
            }
        }
    }
}

}  // extern "C"
