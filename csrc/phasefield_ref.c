/* phasefield_ref: independent native CPU oracle for the JAX framework.
 *
 * Plays the role the standalone C conjugate-gradient program plays in the
 * reference's test strategy (SURVEY.md #25, `cojugate_gradient.c`): a
 * from-scratch, dependency-free implementation of the same *mathematics*
 * (5-point boundary-aware stencils, the coupled Allen-Cahn + heat RHS,
 * matrix-free CG, fused field statistics) in a different language and
 * memory model, used by tests/test_c_oracle.py to cross-validate the
 * JAX/Pallas implementations.  Also exposes a halo-padded matvec variant:
 * the single-node twin of the framework's inter-chip halo exchange, so the
 * pad semantics themselves have a native oracle.
 *
 * Built at test time with `cc -O2 -shared -fPIC`, loaded through ctypes.
 */
#include <math.h>
#include <stddef.h>
#include <string.h>

#define BC_PERIODIC 0
#define BC_DIRICHLET 1
#define BC_NEUMANN 2

typedef struct PfParams {
    int nx, ny;
    int phi_bc, t_bc;
    double L0, dt, L, xi, a, b, alpha, beta, gamma, Tm;
    double S, m0, theta0;
    int corrector_guess;
    double fu;
} PfParams;

static double sample(const double *m, int x, int y, int nx, int ny, int bc) {
    if (bc == BC_PERIODIC) {
        x = (x % nx + nx) % nx;
        y = (y % ny + ny) % ny;
        return m[(size_t)y * nx + x];
    }
    int cx = x < 0 ? 0 : (x >= nx ? nx - 1 : x);
    int cy = y < 0 ? 0 : (y >= ny ? ny - 1 : y);
    double v = m[(size_t)cy * nx + cx];
    if (bc == BC_DIRICHLET && (x != cx || y != cy))
        return -v; /* mirror through zero boundary value */
    return v;
}

void pf_rhs(const double *F, const double *U, double *dF, double *dU,
            const PfParams *p) {
    const int nx = p->nx, ny = p->ny;
    const double dx = p->L0 / nx, dy = p->L0 / ny;
    const double i2dx = 1.0 / (2 * dx), i2dy = 1.0 / (2 * dy);
    const double idx2 = 1.0 / (dx * dx), idy2 = 1.0 / (dy * dy);
    const double k0f = p->a / (p->xi * p->xi * p->alpha);
    const double k2f = p->b * p->beta / p->alpha;
    const double k1f = 1.0 / p->alpha;
    for (int y = 0; y < ny; y++) {
        for (int x = 0; x < nx; x++) {
            double cF = sample(F, x, y, nx, ny, p->phi_bc);
            double eF = sample(F, x + 1, y, nx, ny, p->phi_bc);
            double wF = sample(F, x - 1, y, nx, ny, p->phi_bc);
            double nF = sample(F, x, y + 1, nx, ny, p->phi_bc);
            double sF = sample(F, x, y - 1, nx, ny, p->phi_bc);
            double cU = sample(U, x, y, nx, ny, p->t_bc);
            double eU = sample(U, x + 1, y, nx, ny, p->t_bc);
            double wU = sample(U, x - 1, y, nx, ny, p->t_bc);
            double nU = sample(U, x, y + 1, nx, ny, p->t_bc);
            double sU = sample(U, x, y - 1, nx, ny, p->t_bc);

            double gx = (eF - wF) * i2dx, gy = (nF - sF) * i2dy;
            double theta = atan2(gy, gx);
            double g = 1.0 - p->S * cos(p->m0 * theta + p->theta0);
            double gnorm = hypot(gx, gy);

            double lapF = (wF - 2 * cF + eF) * idx2 + (sF - 2 * cF + nF) * idy2;
            double lapU = (wU - 2 * cU + eU) * idx2 + (sU - 2 * cU + nU) * idy2;

            double k0 = g * cF * (1 - cF) * (cF - 0.5) * k0f;
            double k2 = gnorm * k2f;
            double k1 = g * k1f;
            double dphi;
            if (p->corrector_guess) {
                double corr = 1 + k2 * p->dt * p->L;
                dphi = (k1 * lapF + k0 - k2 * (cU - p->Tm + p->dt * lapU)) / corr;
            } else {
                dphi = k1 * lapF + k0 - k2 * (cU - p->Tm);
            }
            size_t i = (size_t)y * nx + x;
            dF[i] = dphi;
            dU[i] = lapU + p->L * dphi + p->fu;
        }
    }
}

/* Constant 5-point operator: out = C*v + X*(E+W) + Y*(N+S), BC-sampled. */
void pf_cross_matvec(const double *v, double *out, int nx, int ny, int bc,
                     double C, double X, double Y) {
    for (int y = 0; y < ny; y++)
        for (int x = 0; x < nx; x++)
            out[(size_t)y * nx + x] =
                C * sample(v, x, y, nx, ny, bc) +
                X * (sample(v, x + 1, y, nx, ny, bc) + sample(v, x - 1, y, nx, ny, bc)) +
                Y * (sample(v, x, y + 1, nx, ny, bc) + sample(v, x, y - 1, nx, ny, bc));
}

/* Variable-coefficient phase operator with per-cell map s. */
void pf_aniso_matvec(const double *v, const double *s, double *out, int nx,
                     int ny, int bc, double Cm1, double X, double Y) {
    for (int y = 0; y < ny; y++)
        for (int x = 0; x < nx; x++) {
            size_t i = (size_t)y * nx + x;
            out[i] =
                (1 + Cm1 * s[i]) * sample(v, x, y, nx, ny, bc) +
                X * s[i] * (sample(v, x + 1, y, nx, ny, bc) + sample(v, x - 1, y, nx, ny, bc)) +
                Y * s[i] * (sample(v, x, y + 1, nx, ny, bc) + sample(v, x, y - 1, nx, ny, bc));
        }
}

/* Halo-padded variant: v has a 1-cell ghost ring (stride nx+2) already
 * holding BC/neighbor values; no boundary logic inside.  The native twin
 * of the framework's halo-exchange-then-pure-stencil path. */
void pf_cross_matvec_padded(const double *vpad, double *out, int nx, int ny,
                            double C, double X, double Y) {
    const int sp = nx + 2;
    for (int y = 0; y < ny; y++)
        for (int x = 0; x < nx; x++) {
            const double *c = vpad + (size_t)(y + 1) * sp + (x + 1);
            out[(size_t)y * nx + x] =
                C * c[0] + X * (c[1] + c[-1]) + Y * (c[sp] + c[-sp]);
        }
}

static double dot(const double *a, const double *b, size_t n) {
    double acc = 0;
    for (size_t i = 0; i < n; i++) acc += a[i] * b[i];
    return acc;
}

/* Matrix-free CG on the constant cross system.  Returns iterations used;
 * *error_out = sqrt(<r,r>/N).  Same control flow contract as the
 * framework's solvers/cg.py (scaled tolerance, eps guards, warm start). */
int pf_cg_cross(const double *b, double *x, const double *x0, int nx, int ny,
                int bc, double C, double X, double Y, double tol,
                int max_iters, double eps, double *error_out,
                double *scratch /* 3*N doubles */) {
    const size_t N = (size_t)nx * ny;
    double *r = scratch, *pv = scratch + N, *Ap = scratch + 2 * N;
    double scaled = tol * tol * (double)N;

    if (x0) {
        memcpy(x, x0, N * sizeof(double));
        pf_cross_matvec(x, Ap, nx, ny, bc, C, X, Y);
        for (size_t i = 0; i < N; i++) { r[i] = b[i] - Ap[i]; pv[i] = r[i]; }
    } else {
        memset(x, 0, N * sizeof(double));
        memcpy(r, b, N * sizeof(double));
        memcpy(pv, b, N * sizeof(double));
    }
    double rr = dot(r, r, N);

    int it = 0;
    for (; it < max_iters; it++) {
        pf_cross_matvec(pv, Ap, nx, ny, bc, C, X, Y);
        double pAp = dot(pv, Ap, N);
        double alpha = rr / (pAp > eps ? pAp : eps);
        for (size_t i = 0; i < N; i++) { x[i] += alpha * pv[i]; r[i] -= alpha * Ap[i]; }
        double rr_new = dot(r, r, N);
        if (rr_new < scaled) { rr = rr_new; break; }
        double beta = rr_new / (rr > eps ? rr : eps);
        for (size_t i = 0; i < N; i++) pv[i] = r[i] + beta * pv[i];
        rr = rr_new;
    }
    *error_out = sqrt(rr / (double)N);
    return it;
}

/* Fused single-pass stats {sum, L1, L2(mean-norm), min, max} of (b - a);
 * pass a = NULL for plain field stats.  Mirrors Reduce::Stats semantics. */
void pf_stats_delta(const double *a, const double *b, size_t n, double out[5]) {
    double sum = 0, l1 = 0, l2 = 0;
    double mn = INFINITY, mx = -INFINITY;
    for (size_t i = 0; i < n; i++) {
        double v = a ? b[i] - a[i] : b[i];
        sum += v;
        l1 += fabs(v);
        l2 += v * v;
        if (v < mn) mn = v;
        if (v > mx) mx = v;
    }
    out[0] = sum;
    out[1] = l1 / (double)n;
    out[2] = sqrt(l2 / (double)n);
    out[3] = mn;
    out[4] = mx;
}
