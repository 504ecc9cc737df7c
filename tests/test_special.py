"""Golden tests for the L0 incomplete-gamma kernels and small-number utils.

Mirrors the reference test strategy in
/root/reference/test/gamma_inc_tests.jl (values, domains, and tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps

from cloudmicrophysics_tpu.utils import special as ut

AVALS = [1.0, 1.5, 2.0, 2.5, 3.5, 5.0, 7.5]
XVALS = [0.1, 0.5, 1.0, 2.5, 5.0, 8.0, 12.0]
PVALS = [0.03125, 0.125, 0.25, 0.5, 0.75, 0.875, 0.96875]


def tols(dtype):
    # reference test/gamma_inc_tests.jl:34-35
    if dtype == np.float32:
        return dict(atol_pq=2e-5, rtol_inv=2e-4)
    return dict(atol_pq=1e-6, rtol_inv=1e-5)


class TestGammaInc:
    def test_accuracy_vs_scipy(self, dtype):
        t = tols(dtype)
        a, x = np.meshgrid(np.array(AVALS), np.array(XVALS))
        a = a.ravel().astype(dtype)
        x = x.ravel().astype(dtype)
        P, Q = ut.gamma_inc(jnp.asarray(a), jnp.asarray(x))
        P_ref = sps.gammainc(a.astype(np.float64), x.astype(np.float64))
        Q_ref = sps.gammaincc(a.astype(np.float64), x.astype(np.float64))
        np.testing.assert_allclose(P, P_ref, atol=t["atol_pq"], rtol=0)
        np.testing.assert_allclose(Q, Q_ref, atol=t["atol_pq"], rtol=0)

    def test_inverse_vs_scipy(self, dtype):
        t = tols(dtype)
        a, p = np.meshgrid(np.array(AVALS), np.array(PVALS))
        a = a.ravel().astype(dtype)
        p = p.ravel().astype(dtype)
        q = (1.0 - p).astype(dtype)
        x = ut.gamma_inc_inv(jnp.asarray(a), jnp.asarray(p), jnp.asarray(q))
        x_ref = sps.gammaincinv(a.astype(np.float64), p.astype(np.float64))
        np.testing.assert_allclose(
            x, x_ref, rtol=t["rtol_inv"], atol=t["rtol_inv"]
        )

    def test_edge_cases(self, dtype):
        a = jnp.asarray(2.5, dtype)
        P, Q = ut.gamma_inc(a, jnp.asarray(0.0, dtype))
        assert P == 0.0 and Q == 1.0
        P, Q = ut.gamma_inc(a, jnp.asarray(-1.0, dtype))
        assert P == 0.0 and Q == 1.0
        P, Q = ut.gamma_inc(a, jnp.asarray(np.inf, dtype))
        assert P == 1.0 and Q == 0.0
        assert ut.gamma_inc_inv(a, jnp.asarray(0.0, dtype), 1.0) == 0.0
        assert np.isinf(ut.gamma_inc_inv(a, jnp.asarray(1.0, dtype), 0.0))

    def test_x_derivative_analytic(self):
        # reference test/gamma_inc_tests.jl:51-59 — f64 finite
        # differences over the whole (a, x) grid in ONE vmapped grad
        # (scalar-at-a-time compiled 49 tiny programs)
        aa, xx = [jnp.asarray(np.ravel(v), jnp.float64) for v in
                  np.meshgrid(AVALS, XVALS)]
        f = lambda a, x: ut.gamma_inc(a, x)[0]
        ad = jax.vmap(jax.grad(f, argnums=1))(aa, xx)
        eps = np.sqrt(np.finfo(np.float64).eps)
        fd = (jax.vmap(f)(aa, xx + eps) - jax.vmap(f)(aa, xx - eps)) \
            / (2 * eps)
        assert np.isfinite(np.asarray(ad)).all()
        np.testing.assert_allclose(np.asarray(ad), np.asarray(fd),
                                   rtol=1e-3, atol=1e-5)

    def test_p_derivative_analytic(self):
        aa, pp = [jnp.asarray(np.ravel(v), jnp.float64) for v in
                  np.meshgrid(AVALS, PVALS)]
        f = lambda a, p: ut.gamma_inc_inv(a, p, 1.0 - p)
        ad = jax.vmap(jax.grad(f, argnums=1))(aa, pp)
        eps = np.sqrt(np.finfo(np.float64).eps)
        fd = (jax.vmap(f)(aa, pp + eps) - jax.vmap(f)(aa, pp - eps)) \
            / (2 * eps)
        assert np.isfinite(np.asarray(ad)).all()
        np.testing.assert_allclose(np.asarray(ad), np.asarray(fd),
                                   rtol=1e-3, atol=1e-4)

    def test_a_derivative_poisoned(self):
        # The a-derivative is unsupported: must NaN-poison, not silently
        # return zero (reference raises; test/gamma_inc_tests.jl:62-66).
        g = jax.grad(lambda a: ut.gamma_inc(a, 3.0)[0])(jnp.float64(2.5))
        assert np.isnan(g)
        g = jax.grad(lambda a: ut.gamma_inc_inv(a, 0.4, 0.6))(jnp.float64(3.0))
        assert np.isnan(g)

    def test_inverse_small_a_above_half(self):
        # Small-a inverses with p just above 0.5: the true root is ~1e-3
        # while the reference's a - log(q) initial guess starts near 1,
        # out of reach of 15 positivity-halving Halley steps (the
        # reference returns ~1e-7 here). Our guess-region fix picks the
        # series-inversion start whenever it lands below 1/2.
        import scipy.special as sps

        pts = [(0.106926, 0.538347), (0.126223, 0.591038),
               (0.100139, 0.651660), (0.122431, 0.657288)]
        for a, p in pts:
            x = float(ut.gamma_inc_inv(
                jnp.float64(a), jnp.float64(p), jnp.float64(1 - p)))
            assert abs(sps.gammainc(a, x) - p) < 1e-10, (a, p, x)

    def test_constant_a_derivative_flows(self):
        # x-derivative still flows when a is a constant
        g = jax.grad(lambda x: ut.gamma_inc(2.5, x)[0])(jnp.float64(3.0))
        assert np.isfinite(g) and g != 0

    def test_ndtri_acklam_vs_scipy(self):
        # the rational normal-inverse-CDF behind the
        # Wilson-Hilferty upper-tail start (Acklam: |rel err| ~1.15e-9)
        import scipy.special as sps

        p = jnp.asarray([1e-9, 1e-6, 0.02, 0.3, 0.5, 0.9, 0.97425,
                         1 - 1e-6, 1 - 1e-9], jnp.float64)
        got = np.asarray(ut._ndtri_acklam(p))
        want = sps.ndtri(np.asarray(p))
        np.testing.assert_allclose(got, want, rtol=5e-9, atol=5e-9)

    def test_reduced_iteration_tail_quantiles(self):
        # PSD integration bounds run n_iters=4: with the WH upper-tail
        # start, both tails must sit within ~3e-7 of the converged
        # inverse over the production a-range (see gamma_inc_inv
        # docstring; the reference's a - log q start needed 6)
        rng = np.random.default_rng(0)
        a = jnp.asarray(10 ** rng.uniform(-0.5, 1.3, 500))
        for p in (1e-5, 1e-6, 1 - 1e-5, 1 - 1e-6):
            pj = jnp.full_like(a, p)
            x4 = ut.gamma_inc_inv(a, pj, 1 - pj, n_iters=4)
            x15 = ut.gamma_inc_inv(a, pj, 1 - pj, n_iters=15)
            np.testing.assert_allclose(np.asarray(x4), np.asarray(x15),
                                       rtol=3e-7, err_msg=str(p))

    def test_extreme_upper_tail_start_clamped(self):
        # For q below ~1e-130 at small-to-moderate a the Wilson-Hilferty
        # start overshoots into the region where dP/dx underflows to 0
        # (x > ~745 at f64) and Halley would freeze on the bad start; the
        # start falls back to the reference's a - log(q) guess there.
        for a in (0.5, 2.0, 5.0):
            for q in (1e-130, 1e-160, 1e-200, 1e-280):
                aj = jnp.float64(a)
                x = float(ut.gamma_inc_inv(aj, jnp.float64(1.0 - q),
                                           jnp.float64(q)))
                want = float(sps.gammainccinv(a, q))
                assert np.isfinite(x), (a, q)
                np.testing.assert_allclose(x, want, rtol=1e-8,
                                           err_msg=str((a, q)))

    def test_jit_and_vmap(self, dtype):
        a = jnp.linspace(0.5, 8.0, 16, dtype=dtype)
        x = jnp.linspace(0.1, 12.0, 16, dtype=dtype)
        P1, _ = jax.jit(ut.gamma_inc)(a, x)
        P2 = jax.vmap(lambda a, x: ut.gamma_inc(a, x)[0])(a, x)
        np.testing.assert_allclose(P1, P2, rtol=1e-6)


class TestSmallNumberUtils:
    def test_eps_values(self):
        assert ut.eps_numerics(np.float32) == pytest.approx(
            np.cbrt(np.finfo(np.float32).tiny)
        )
        assert ut.eps_numerics_2M_M(np.float32) == np.finfo(np.float32).eps

    def test_clamp(self):
        np.testing.assert_array_equal(
            ut.clamp_to_nonneg(jnp.array([-1.0, 0.0, 2.0])),
            jnp.array([0.0, 0.0, 2.0]),
        )

    def test_fac(self):
        assert ut.fac(0) == 1
        assert ut.fac(5) == 120
        with pytest.raises(ValueError):
            ut.fac(21)

    def test_logsumexp(self):
        x = jnp.array([1.0, 2.0, 3.0])
        np.testing.assert_allclose(
            ut.logsumexp(x), sps.logsumexp(np.array(x)), rtol=1e-12
        )
        assert np.isneginf(ut.logsumexp(jnp.array([-np.inf, -np.inf])))
        assert np.isposinf(ut.logsumexp(jnp.array([np.inf, 1.0])))

    def test_sgs_weight_properties(self, dtype):
        a_half = dtype.type(0.1)
        w = ut.sgs_weight_function
        assert w(dtype.type(-0.5), a_half) == 0.0
        assert w(dtype.type(0.0), a_half) == 0.0
        assert w(dtype.type(1.5), a_half) == 1.0
        np.testing.assert_allclose(w(a_half, a_half), 0.5, atol=1e-5)
        # monotone
        avals = jnp.linspace(0.0, 1.0, 101, dtype=dtype)
        ws = w(avals, a_half)
        assert np.all(np.diff(np.asarray(ws)) >= -1e-7)
        assert np.all((np.asarray(ws) >= 0) & (np.asarray(ws) <= 1))

    def test_rime_mass_fraction(self, dtype):
        one = dtype.type(1.0)
        # Normal ratio
        np.testing.assert_allclose(
            ut.rime_mass_fraction(dtype.type(5e-4), dtype.type(1e-3)),
            0.5,
            rtol=1e-6,
        )
        # q_rim > q_ice clamps to 1
        np.testing.assert_allclose(
            ut.rime_mass_fraction(dtype.type(2e-3), dtype.type(1e-3)),
            1.0,
            rtol=1e-6,
        )
        # Zero denominator stays finite at 0
        assert ut.rime_mass_fraction(one, dtype.type(0.0)) == 0.0

    def test_rime_density(self, dtype):
        np.testing.assert_allclose(
            ut.rime_density(dtype.type(1e-3), dtype.type(2e-6)),
            500.0,
            rtol=1e-6,
        )
        assert ut.rime_density(dtype.type(1e-3), dtype.type(0.0)) == 0.0
