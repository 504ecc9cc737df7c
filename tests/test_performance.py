"""Performance-regression budgets (reference test/performance_tests.jl).

Each hot entry point goes through :func:`cloudmicrophysics_tpu.perf.bench_press`,
which enforces (a) a per-call latency budget on the compiled call, (b) the
zero-retrace invariant (XLA analog of the reference's zero-allocation
gate), and (c) no dtype promotion (analog of the FT return-type check).

Budgets are CPU wall times on a 4096-point float32 batch with ~15-30x
headroom over measured dev-machine times — they catch catastrophic
regressions (eager fallback, per-element dispatch, accidental f64
promotion), not few-percent drift. Device throughput is measured on the
GPU by bench.py / benchmarks/bench_suite.py instead.
"""

import jax
import jax.numpy as jnp
import pytest

import cloudmicrophysics_tpu as cm
from cloudmicrophysics_tpu.models.tendencies import (
    bulk_tendencies_0m,
    bulk_tendencies_1m,
    bulk_tendencies_2m,
)
from cloudmicrophysics_tpu.ops import m1 as CM1
from cloudmicrophysics_tpu.perf import bench_press
from cloudmicrophysics_tpu.utils.special import gamma_inc, gamma_inc_inv

TPS = cm.parameters.ThermodynamicsParameters()
N = 4096
F = jnp.float32


def full(v):
    return jnp.full((N,), v, F)


MS = 1e6  # ns per ms


class TestNumericsBudgets:
    def test_gamma_inc(self):
        r = bench_press(gamma_inc, (full(2.5), full(1.2)), 5 * MS)
        assert r.n_traces == 1

    def test_gamma_inc_inv(self):
        bench_press(gamma_inc_inv, (full(2.5), full(0.3), full(0.7)),
                    30 * MS)


class TestSchemeBudgets:
    def test_bulk_0m(self):
        mp = cm.parameters.microphysics_0m_params()
        bench_press(
            lambda T, ql, qi: bulk_tendencies_0m(mp, TPS, T, ql, qi),
            (full(278.0), full(1e-3), full(1e-4)), 5 * MS,
            name="bulk_0m")

    def test_bulk_1m(self):
        mp = cm.parameters.microphysics_1m_params()
        bench_press(
            lambda rho, T, qt, ql, qi, qr, qs: bulk_tendencies_1m(
                mp, TPS, rho, T, qt, ql, qi, qr, qs),
            (full(1.1), full(278.0), full(5e-3), full(1e-3), full(1e-4),
             full(5e-4), full(2e-4)), 10 * MS,
            name="bulk_1m")

    def test_rain_terminal_velocity_chen(self):
        mp = cm.parameters.microphysics_1m_params()
        tv = cm.parameters.terminal_velocity_params()
        bench_press(
            lambda rho, q: CM1.terminal_velocity(
                mp.precip.rain, tv.chen2022.rain, rho, q),
            (full(1.1), full(1e-3)), 5 * MS,
            name="vt_rain_chen2022")

    def test_bulk_2m_warm(self):
        mp = cm.parameters.microphysics_2m_params()
        bench_press(
            lambda rho, T, qt, ql, nl, qr, nr: bulk_tendencies_2m(
                mp, TPS, rho, T, qt, ql, nl, qr, nr),
            (full(1.1), full(288.0), full(6e-3), full(1e-3), full(9e7),
             full(5e-4), full(9e5)), 15 * MS,
            name="bulk_2m_warm")

    @pytest.mark.slow
    def test_bulk_2m_p3(self):
        # the 2-D collision quadrature dominates; 512-point batch,
        # measured ~60 ms on CPU -> 1.5 s budget
        mp = cm.parameters.microphysics_2m_params(with_ice=True)
        n = 512
        f = lambda v: jnp.full((n,), v, F)
        bench_press(
            lambda rho, T, qt, ql, nl, qr, nr, qi, ni, qrim, brim:
            bulk_tendencies_2m(mp, TPS, rho, T, qt, ql, nl, qr, nr,
                               qi, ni, qrim, brim),
            (f(1.1), f(263.0), f(4e-3), f(5e-4), f(9e7), f(2e-4), f(9e5),
             f(1e-4), f(9e4), f(3e-5), f(3e-5 / 400)), 1500 * MS,
            name="bulk_2m_p3")

    def test_aerosol_activation(self):
        from cloudmicrophysics_tpu.ops import aerosol_activation as AA
        from cloudmicrophysics_tpu.parameters.aerosol import (
            AerosolActivationParameters,
            AerosolDistribution,
            ModeKappa,
        )

        ap = AerosolActivationParameters()
        aip = cm.parameters.AirProperties()
        mode = ModeKappa(r_dry=5e-8, stdev=2.0, N=1e8, vol_mix_ratio=(1.0,),
                         mass_mix_ratio=(1.0,), molar_mass=(0.13214,),
                         kappa=(0.53,))
        ad = AerosolDistribution(modes=(mode,))
        bench_press(
            lambda T, p, w, qt: AA.total_N_activated(
                ap, ad, aip, TPS, T, p, w, qt, 0.0, 0.0),
            (full(285.0), full(9e4), full(0.5), full(8e-3)), 10 * MS,
            name="arg_activation")


class TestP3Budgets:
    """P3 hot entry points (reference test/performance_tests.jl:200-280:
    state construction, shape solve, terminal velocities, processes)."""

    def _state(self):
        mp = cm.parameters.microphysics_2m_params(with_ice=True)
        from cloudmicrophysics_tpu.ops import p3 as P3

        st = P3.state_from_prognostic(
            mp.ice.scheme, full(1e-4 * 1.1), full(9e4 * 1.1),
            full(3e-5 * 1.1), full(3e-5 / 400 * 1.1))
        return mp, st, P3.get_distribution_loglambda(st)

    def test_p3_state_ctor(self):
        mp = cm.parameters.microphysics_2m_params(with_ice=True)
        from cloudmicrophysics_tpu.ops import p3 as P3

        # check_dtype off: the returned P3State carries the params pytree,
        # whose leaves are f64 under the suite's x64 mode regardless of
        # the f32 prognostic inputs (static scheme constants, not data)
        bench_press(
            lambda L, N, Lr, Br: P3.state_from_prognostic(
                mp.ice.scheme, L, N, Lr, Br),
            (full(1e-4), full(9e4), full(3e-5), full(3e-5 / 400)), 10 * MS,
            name="p3_state_ctor", check_dtype=False)

    def test_p3_shape_solver(self):
        mp, st, _ = self._state()
        from cloudmicrophysics_tpu.ops import p3 as P3

        bench_press(
            lambda L, N: P3.get_distribution_loglambda(
                P3.state_from_prognostic(mp.ice.scheme, L, N,
                                         full(3e-5), full(3e-5 / 400))),
            (full(1e-4), full(9e4)), 60 * MS, name="p3_shape_solver")

    def test_p3_terminal_velocities(self):
        mp, st, ll = self._state()
        from cloudmicrophysics_tpu.ops import p3 as P3

        vel = mp.ice.terminal_velocity
        bench_press(
            lambda rho, ll: P3.ice_terminal_velocity_number_weighted(
                vel, rho, st, ll, quad=mp.ice.quad),
            (full(1.1), ll), 60 * MS, name="p3_vt_number")
        bench_press(
            lambda rho, ll: P3.ice_terminal_velocity_mass_weighted(
                vel, rho, st, ll, quad=mp.ice.quad),
            (full(1.1), ll), 60 * MS, name="p3_vt_mass")

    def test_het_ice_nucleation(self):
        from cloudmicrophysics_tpu.ops import p3_processes as P3P
        from cloudmicrophysics_tpu.parameters.aerosol_species import Illite

        bench_press(
            lambda ql, Nl, RH, T, rho: P3P.het_ice_nucleation(
                Illite(), TPS, ql, Nl, RH, T, rho),
            (full(1e-4), full(1e8), full(1.0), full(251.0), full(1.1)),
            5 * MS, name="het_ice_nucleation")


class TestMoreSchemeBudgets:
    """2M self-collection/breakup, reflectivity/r_eff, NPF rates
    (reference test/performance_tests.jl:120-180, 300-356)."""

    def test_rain_self_collection_and_breakup(self):
        from cloudmicrophysics_tpu.ops import m2 as CM2

        sb = cm.parameters.microphysics_2m_params().warm_rain.seifert_beheng
        bench_press(
            lambda q, rho, N: CM2.rain_self_collection_and_breakup(
                sb, q, rho, N),
            (full(5e-4), full(1.1), full(9e5)), 10 * MS,
            name="rain_sc_breakup")

    def test_reflectivity_and_r_eff_2m(self):
        from cloudmicrophysics_tpu.ops import diagnostics as CMD

        sb = cm.parameters.microphysics_2m_params().warm_rain.seifert_beheng
        bench_press(
            lambda ql, qr, Nl, Nr, rho: CMD.radar_reflectivity_2m(
                sb, ql, qr, Nl, Nr, rho),
            (full(1e-3), full(5e-4), full(9e7), full(9e5), full(1.1)),
            10 * MS, name="radar_reflectivity_2m")
        bench_press(
            lambda ql, qr, Nl, Nr, rho: CMD.effective_radius_2m(
                sb, ql, qr, Nl, Nr, rho),
            (full(1e-3), full(5e-4), full(9e7), full(9e5), full(1.1)),
            10 * MS, name="effective_radius_2m")

    def test_h2so4_nucleation_rate(self):
        from cloudmicrophysics_tpu.ops import nucleation as NPF
        from cloudmicrophysics_tpu.parameters.modal_nucleation import (
            H2SO4NucleationParameters,
        )

        mn = H2SO4NucleationParameters()
        bench_press(
            lambda c, T: NPF.h2so4_nucleation_rate(
                c, full(1.0), full(1.0), T, mn),
            (full(1e6), full(208.0)), 10 * MS,
            name="h2so4_nucleation_rate")


class TestColumnBudget:
    def test_step_column_1m(self):
        from cloudmicrophysics_tpu.models.column import (
            ColumnState,
            step_column_1m,
        )

        mp = cm.parameters.microphysics_1m_params()
        tv = cm.parameters.terminal_velocity_params()
        ncol, nlev = 128, 32
        c = lambda v: jnp.full((ncol, nlev), v, F)
        state = ColumnState(rho=c(1.1), T=c(278.0), q_tot=c(5e-3),
                            q_lcl=c(1e-3), q_icl=c(1e-4), q_rai=c(1e-4),
                            q_sno=c(1e-5))
        bench_press(
            lambda s: step_column_1m(s, mp, TPS, tv, F(1.0), F(100.0)),
            (state,), 20 * MS, name="step_column_1m")


class TestBroadenedBudgets:
    """Round-5 budget breadth (VERDICT r4 #6), matching the reference's
    coverage in test/performance_tests.jl:80-356: melt, self-collection,
    collisions, Bigg freezing, Frostenberg INPC, non-equilibrium rates,
    Liu-Hallett r_eff, a parcel step, distribution-tool quantiles, and
    the 1M accretion/evaporation/melt family."""

    @staticmethod
    def _p3():
        from cloudmicrophysics_tpu.ops import p3 as P3

        mp = cm.parameters.microphysics_2m_params(with_ice=True,
                                                  quadrature_order=8)
        st = P3.state_from_prognostic(
            mp.ice.scheme, full(1e-4 * 1.1), full(9e4 * 1.1),
            full(3e-5 * 1.1), full(3e-5 / 400 * 1.1))
        return mp, st, P3.get_distribution_loglambda(st)

    def test_ice_melt(self):
        from cloudmicrophysics_tpu.ops import p3_processes as P3P

        mp, st, ll = self._p3()
        bench_press(
            lambda T, rho, ll: P3P.ice_melt(
                mp.ice.terminal_velocity, mp.warm_rain.air_properties,
                TPS, T, rho, st, ll, quad=mp.ice.quad),
            (full(275.0), full(1.1), ll), 60 * MS, name="ice_melt")

    def test_ice_self_collection(self):
        from cloudmicrophysics_tpu.ops import p3_processes as P3P

        mp, st, ll = self._p3()
        bench_press(
            lambda rho, ll: P3P.ice_self_collection(
                st, ll, mp.ice.terminal_velocity, rho, quad=mp.ice.quad),
            (full(1.1), ll), 120 * MS, name="ice_self_collection")

    def test_collision_sources(self):
        from cloudmicrophysics_tpu.ops import p3_processes as P3P

        mp, st, ll = self._p3()
        bench_press(
            lambda ql, nl, qr, nr, rho, T, ll:
            P3P.bulk_liquid_ice_collision_sources(
                st, ll, mp.ice.cloud_pdf, mp.ice.rain_pdf, ql * rho,
                nl * rho, qr * rho, nr * rho,
                mp.warm_rain.air_properties, TPS,
                mp.ice.terminal_velocity, rho, T, quad=mp.ice.quad),
            (full(1e-3), full(9e7), full(5e-4), full(9e5), full(1.1),
             full(263.0), ll), 200 * MS, name="collision_sources")

    def test_bigg_freezing(self):
        from cloudmicrophysics_tpu.ops import ice_nucleation as CMI

        mp = cm.parameters.microphysics_2m_params(with_ice=True)
        bench_press(
            lambda q, rho, N, T: CMI.liquid_freezing_rate_cloud(
                mp.ice.rain_freezing, mp.ice.cloud_pdf, TPS, q, rho, N, T),
            (full(1e-3), full(1.1), full(1e8), full(260.0)), 15 * MS,
            name="bigg_freezing_cloud")
        bench_press(
            lambda q, rho, N, T: CMI.liquid_freezing_rate_rain(
                mp.ice.rain_freezing, mp.ice.rain_pdf, TPS, q, rho, N, T),
            (full(5e-4), full(1.1), full(1e6), full(260.0)), 15 * MS,
            name="bigg_freezing_rain")

    def test_frostenberg_inpc(self):
        from cloudmicrophysics_tpu.ops import ice_nucleation as CMI
        from cloudmicrophysics_tpu.parameters.ice_nucleation import (
            Frostenberg2023,
        )

        fp = Frostenberg2023()
        bench_press(lambda T: CMI.INP_concentration_mean(fp, T),
                    (full(253.0),), 5 * MS, name="inpc_mean")
        bench_press(
            lambda inpc, T: CMI.INP_concentration_frequency(fp, inpc, T),
            (full(1e4), full(253.0)), 5 * MS, name="inpc_frequency")

    def test_noneq_rates(self):
        from cloudmicrophysics_tpu.ops import noneq as NE
        from cloudmicrophysics_tpu.ops.states import MicroState, ThermoState

        mp = cm.parameters.microphysics_1m_params()
        mic = MicroState(q_tot=full(6e-3), q_lcl=full(1e-3),
                         q_icl=full(1e-4), q_rai=full(1e-4),
                         q_sno=full(1e-5))
        th = ThermoState(rho=full(1.1), T=full(268.0))
        bench_press(lambda mic, th: NE.conv_q_vap_to_q_lcl(mp, TPS, mic, th),
                    (mic, th), 10 * MS, name="noneq_cond_evap")
        bench_press(lambda mic, th: NE.conv_q_vap_to_q_icl(mp, TPS, mic, th),
                    (mic, th), 15 * MS, name="noneq_dep_subl")

    def test_tau_relax_frostenberg(self):
        from cloudmicrophysics_tpu.ops import noneq as NE
        from cloudmicrophysics_tpu.parameters.ice_nucleation import (
            Frostenberg2023,
        )

        mp = cm.parameters.microphysics_1m_params()
        aps = cm.parameters.AirProperties()
        bench_press(
            lambda q, T: NE.tau_relax_frostenberg(
                mp.cloud.ice, aps, Frostenberg2023(), q, T),
            (full(1e-4), full(253.0)), 10 * MS, name="tau_relax_frostenberg")

    def test_liu_hallett_r_eff(self):
        from cloudmicrophysics_tpu.ops import diagnostics as CMD

        bench_press(
            lambda rho, ql, Nl: CMD.effective_radius_liu_hallet_97(
                1000.0, rho, ql, Nl),
            (full(1.1), full(1e-3), full(1e8)), 5 * MS,
            name="liu_hallett_r_eff")

    def test_distribution_quantiles(self):
        from cloudmicrophysics_tpu.utils import distributions as DT

        bench_press(
            lambda nu, B, Y: DT.generalized_gamma_quantile(nu, full(1.0),
                                                           B, Y),
            (full(2.5), full(1e4), full(0.999)), 40 * MS,
            name="gen_gamma_quantile")
        bench_press(lambda Dm, Y: DT.exponential_quantile(Dm, Y),
                    (full(1e-4), full(0.999)), 5 * MS,
                    name="exponential_quantile")

    def test_parcel_single_step(self):
        from cloudmicrophysics_tpu.models import parcel as PM

        params = PM.parcel_params(condensation_growth="Condensation",
                                  const_dt=0.1, w=1.0)
        y = PM.ParcelState(S_l=full(1.02), p_air=full(8e4), T=full(278.0),
                           q_vap=full(6e-3), q_liq=full(1e-3),
                           q_ice=full(0.0), N_aer=full(1e8),
                           N_liq=full(1e8), N_ice=full(0.0),
                           ln_inpc=full(0.0))
        bench_press(
            lambda y: PM.parcel_tendencies(params, y, 0.0, full(0.0)),
            (y,), 20 * MS, name="parcel_single_step")

    def test_1m_accretion_family(self):
        from cloudmicrophysics_tpu.ops import m1 as M1
        from cloudmicrophysics_tpu.ops.states import MicroState, ThermoState

        mp = cm.parameters.microphysics_1m_params()
        mic = MicroState(q_tot=full(6e-3), q_lcl=full(1e-3),
                         q_icl=full(1e-4), q_rai=full(5e-4),
                         q_sno=full(5e-4))
        th = ThermoState(rho=full(1.1), T=full(268.0))
        for fn, budget in ((M1.accretion_cloud_liquid_rain, 10),
                           (M1.accretion_cloud_liquid_snow, 10),
                           (M1.accretion_cloud_ice_snow, 10),
                           (M1.accretion_snow_rain, 20),
                           (M1.conv_q_rai_to_q_vap, 15),
                           (M1.conv_q_sno_to_q_vap, 15),
                           (M1.conv_q_sno_to_q_rai, 10)):
            bench_press(lambda mic, th, fn=fn: fn(mp, TPS, mic, th),
                        (mic, th), budget * MS, name=fn.__name__)
