"""Fused-API (BMT) + column model + sharding integration tests.

Mirrors the reference test strategy in
/root/reference/test/bulk_tendencies_tests.jl (process routing, finiteness
sweeps, water conservation) plus the column-driver / virtual-mesh checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cloudmicrophysics_tpu.models import column as COL
from cloudmicrophysics_tpu.models import tendencies as BMT
from cloudmicrophysics_tpu.ops import noneq
from cloudmicrophysics_tpu.ops.states import MicroState, ThermoState
from cloudmicrophysics_tpu.parameters import (
    ThermodynamicsParameters,
    microphysics_0m_params,
    microphysics_1m_params,
    terminal_velocity_params,
)
from cloudmicrophysics_tpu.parameters import m1 as P1

TPS = ThermodynamicsParameters()
MP = microphysics_1m_params()
TV = terminal_velocity_params()


class TestNonEq:
    def test_condensation_sign(self, dtype):
        # supersaturated -> condensation (positive); subsaturated with
        # liquid -> evaporation (negative)
        rho, T = dtype.type(1.1), dtype.type(280.0)
        from cloudmicrophysics_tpu.ops import thermo as TDI

        q_sat = float(TDI.saturation_vapor_specific_content_over_liquid(
            TPS, jnp.asarray(T), jnp.asarray(rho)))
        mic_sup = MicroState(*[jnp.asarray(v, dtype) for v in
                               (1.2 * q_sat, 0.0, 0.0, 0.0, 0.0)])
        mic_sub = MicroState(*[jnp.asarray(v, dtype) for v in
                               (0.8 * q_sat + 1e-4, 1e-4, 0.0, 0.0, 0.0)])
        th = ThermoState(jnp.asarray(rho), jnp.asarray(T))
        assert float(noneq.conv_q_vap_to_q_lcl(MP, TPS, mic_sup, th)) > 0
        assert float(noneq.conv_q_vap_to_q_lcl(MP, TPS, mic_sub, th)) < 0

    def test_inp_limiter(self):
        # no ice deposition above freezing
        rho, T = 1.1, 280.0
        from cloudmicrophysics_tpu.ops import thermo as TDI

        q_sat_i = float(TDI.saturation_vapor_specific_content_over_ice(
            TPS, jnp.float64(T), jnp.float64(rho)))
        mic = MicroState(*[jnp.float64(v) for v in
                           (1.5 * q_sat_i, 0.0, 0.0, 0.0, 0.0)])
        th = ThermoState(jnp.float64(rho), jnp.float64(T))
        assert noneq.conv_q_vap_to_q_icl(MP, TPS, mic, th) == 0
        # below freezing, deposition happens
        th_c = ThermoState(jnp.float64(rho), jnp.float64(260.0))
        q_sat_ic = float(TDI.saturation_vapor_specific_content_over_ice(
            TPS, jnp.float64(260.0), jnp.float64(rho)))
        mic_c = MicroState(*[jnp.float64(v) for v in
                             (1.2 * q_sat_ic, 0.0, 0.0, 0.0, 0.0)])
        assert float(noneq.conv_q_vap_to_q_icl(MP, TPS, mic_c, th_c)) > 0

    def test_frostenberg_timescale(self):
        mp_f = microphysics_1m_params(
            cloud_ice_formation=P1.TEMPERATURE_DEPENDENT)
        rho = 1.1
        from cloudmicrophysics_tpu.ops import thermo as TDI

        for T in (250.0, 260.0):
            q_sat_i = float(TDI.saturation_vapor_specific_content_over_ice(
                TPS, jnp.float64(T), jnp.float64(rho)))
            mic = MicroState(*[jnp.float64(v) for v in
                               (1.2 * q_sat_i, 0.0, 1e-5, 0.0, 0.0)])
            th = ThermoState(jnp.float64(rho), jnp.float64(T))
            r = float(noneq.conv_q_vap_to_q_icl(mp_f, TPS, mic, th))
            assert np.isfinite(r) and r > 0

    def test_cloud_sedimentation_velocities(self, dtype):
        rho = jnp.asarray(1.1, dtype)
        v_liq = noneq.terminal_velocity(
            MP.cloud.liquid, TV.stokes, rho, jnp.asarray(1e-3, dtype))
        v_ice = noneq.terminal_velocity(
            MP.cloud.ice, TV.chen2022.small_ice, rho, jnp.asarray(1e-4, dtype))
        assert 0 < float(v_liq) < 1.0   # cloud droplets fall slowly
        assert 0 < float(v_ice) < 2.0
        assert noneq.terminal_velocity(
            MP.cloud.liquid, TV.stokes, rho, jnp.asarray(0.0, dtype)) == 0
        assert noneq.terminal_velocity(
            MP.cloud.ice, TV.chen2022.small_ice, rho,
            jnp.asarray(0.0, dtype)) == 0


class TestBMT1M:
    def _state(self, T, dt=np.float64, q=(2e-2, 1e-3, 5e-4, 5e-4, 5e-4)):
        return [jnp.asarray(1.1, dt), jnp.asarray(T, dt)] + [
            jnp.asarray(v, dt) for v in q]

    def test_water_conservation_cold(self):
        # hydrometeor tendencies exchange mass with vapor only through
        # phase-change terms; intra-hydrometeor exchanges cancel
        rho, T, *qs = self._state(260.0)
        tend, src = BMT.bulk_tendencies_1m(
            MP, TPS, rho, T, *qs, mode="instantaneous_verbose")
        total = (tend.dq_lcl_dt + tend.dq_icl_dt
                 + tend.dq_rai_dt + tend.dq_sno_dt)
        phase = (src.S_phase_change_vap_lcl + src.S_phase_change_vap_icl
                 + src.S_phase_change_vap_rai + src.S_phase_change_vap_sno)
        np.testing.assert_allclose(float(total), float(phase), rtol=1e-10)

    def test_warm_routing(self):
        # above freezing: no cold-arm accretion, melt terms active
        rho, T, *qs = self._state(TPS.T_freeze + 5)
        _, src = BMT.bulk_tendencies_1m(
            MP, TPS, rho, T, *qs, mode="instantaneous_verbose")
        assert src.S_accr_lcl_sno_cold == 0
        assert src.S_accr_rai_sno_cold == 0
        assert float(src.S_melt_sno_rai) > 0
        assert float(src.S_accr_lcl_sno_warm) > 0

    def test_cold_routing(self):
        rho, T, *qs = self._state(TPS.T_freeze - 10)
        _, src = BMT.bulk_tendencies_1m(
            MP, TPS, rho, T, *qs, mode="instantaneous_verbose")
        assert src.S_accr_lcl_sno_warm == 0
        assert src.S_accr_rai_sno_warm == 0
        assert src.S_melt_sno_rai == 0
        assert src.S_melt_icl_lcl == 0
        assert float(src.S_accr_rai_sno_cold) > 0

    def test_finiteness_sweep(self, dtype):
        # curated sweep over (T, q) grid, all outputs finite
        T = jnp.asarray(np.linspace(230, 310, 9), dtype)
        q = jnp.asarray(np.geomspace(1e-12, 2e-2, 9), dtype)
        Tg, qg = jnp.meshgrid(T, q)
        rho = jnp.full_like(Tg, 1.0)
        tend = BMT.bulk_tendencies_1m(
            MP, TPS, rho, Tg, 2e-2 + 0 * qg, qg, qg / 2, qg / 3, qg / 4)
        for leaf in tend:
            assert np.all(np.isfinite(leaf))

    def test_zero_state(self):
        rho, T, *qs = self._state(270.0, q=(0, 0, 0, 0, 0))
        tend = BMT.bulk_tendencies_1m(MP, TPS, rho, T, *qs)
        # dry subsaturated state: no hydrometeor production
        for v in tend:
            assert float(v) <= 0 or abs(float(v)) < 1e-15

    def test_linearized_average_matches_instantaneous_small_dt(self):
        # for tiny dt the implicit substep tendency ~ instantaneous
        rho, T, *qs = self._state(265.0)
        inst = BMT.bulk_tendencies_1m(MP, TPS, rho, T, *qs)
        lin = BMT.bulk_tendencies_1m(
            MP, TPS, rho, T, *qs, mode="linearized_average", dt=1e-4, nsub=1)
        for a, b in zip(inst, lin):
            np.testing.assert_allclose(float(a), float(b), rtol=2e-3,
                                       atol=1e-12)

    def test_linearized_average_stable_large_dt(self):
        # large dt: implicit solve keeps q non-negative-ish tendencies
        rho, T, *qs = self._state(275.0)
        lin = BMT.bulk_tendencies_1m(
            MP, TPS, rho, T, *qs, mode="linearized_average", dt=600.0, nsub=4)
        q0 = [float(v) for v in qs[1:]]
        for dq, q in zip(lin, q0):
            q_new = q + 600.0 * float(dq)
            assert q_new >= -1e-12  # no overshoot below zero
        for v in lin:
            assert np.isfinite(float(v))

    def test_0m(self):
        mp0 = microphysics_0m_params()
        r = BMT.bulk_tendencies_0m(
            mp0, TPS, jnp.float64(280.0), jnp.float64(3e-3), jnp.float64(0.0))
        assert float(r) < 0


class TestColumnModel:
    def _make_state(self, ncol=8, nlev=16, dtype=np.float32):
        rng = np.random.default_rng(42)
        shape = (ncol, nlev)
        return COL.ColumnState(
            rho=jnp.asarray(np.linspace(1.2, 0.5, nlev)[None, :]
                            * np.ones((ncol, 1)), dtype),
            T=jnp.asarray(np.linspace(295.0, 230.0, nlev)[None, :]
                          * np.ones((ncol, 1)), dtype),
            q_tot=jnp.asarray(1.5e-2 * np.ones(shape), dtype),
            q_lcl=jnp.asarray(1e-3 * rng.random(shape), dtype),
            q_icl=jnp.asarray(2e-4 * rng.random(shape), dtype),
            q_rai=jnp.asarray(5e-4 * rng.random(shape), dtype),
            q_sno=jnp.asarray(2e-4 * rng.random(shape), dtype),
        )

    def test_sedimentation_conserves_mass_except_surface(self):
        # column-integrated rho*q change = - surface outflow flux
        rho = jnp.ones((4, 10))
        q = jnp.asarray(np.random.default_rng(1).random((4, 10)) * 1e-3)
        w = jnp.full((4, 10), 2.0)
        dz = 50.0
        dqdt = COL.sedimentation_tendency(rho, q, w, dz)
        col_change = jnp.sum(rho * dqdt * dz, axis=-1)
        surface_flux = rho[:, 0] * w[:, 0] * q[:, 0]
        np.testing.assert_allclose(col_change, -surface_flux, rtol=1e-6)

    def test_step_runs_and_stays_finite(self):
        state = self._make_state()
        step = jax.jit(lambda s: COL.step_column_1m(
            s, MP, TPS, TV, dt=1.0, dz=100.0))
        for _ in range(5):
            state = step(state)
        for leaf in state:
            assert np.all(np.isfinite(leaf))
            assert np.all(np.asarray(leaf) >= 0) or leaf is state.T

    def test_rain_falls_downward(self):
        # put rain aloft; after stepping, rain appears below
        state = self._make_state(ncol=2, nlev=20)
        q_rai = np.zeros((2, 20), np.float32)
        q_rai[:, 15] = 1e-3
        state = state._replace(q_rai=jnp.asarray(q_rai),
                               q_lcl=jnp.zeros_like(state.q_lcl),
                               q_icl=jnp.zeros_like(state.q_icl),
                               q_sno=jnp.zeros_like(state.q_sno),
                               q_tot=jnp.full_like(state.q_tot, 1e-3))
        step = jax.jit(lambda s: COL.step_column_1m(
            s, MP, TPS, TV, dt=2.0, dz=50.0, sediment_cloud=False))
        for _ in range(10):
            state = step(state)
        q_after = np.asarray(state.q_rai)
        assert q_after[0, 14] > 0  # fell into lower levels
        assert q_after[0, 15] < 1e-3

    def test_sharded_step(self):
        from cloudmicrophysics_tpu.parallel import column_mesh, shard_columns

        mesh = column_mesh()
        state = shard_columns(self._make_state(ncol=16), mesh)
        step = jax.jit(lambda s: COL.step_column_1m(
            s, MP, TPS, TV, dt=1.0, dz=100.0))
        out = step(state)
        assert "columns" in str(out.q_rai.sharding)
        for leaf in out:
            assert np.all(np.isfinite(leaf))


class TestGraftEntry:
    def test_entry_compiles(self):
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        import __graft_entry__ as GE

        fn, args = GE.entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
        for leaf in jax.tree_util.tree_leaves(out):
            assert np.all(np.isfinite(leaf))

    @pytest.mark.slow
    def test_dryrun_multichip(self):
        # Slow tier: the driver itself runs dryrun_multichip on the
        # 8-device virtual mesh, so the default tier does not pay its
        # ~35 s again.
        # Run in a fresh interpreter, exactly as the driver does: compiling
        # the 8-way-partitioned P3 program on top of a long-lived pytest
        # process has hit XLA:CPU compiler stack exhaustion.
        import os
        import subprocess
        import sys
        from pathlib import Path

        repo = str(Path(__file__).resolve().parents[1])
        code = (
            f"import sys; sys.path.insert(0, {repo!r});"
            "import __graft_entry__ as GE; GE.dryrun_multichip(8)"
        )
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=8",
        )
        proc = subprocess.run(
            [sys.executable, "-c", code], env=env,
            capture_output=True, text=True, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-2000:]


class TestColumnP3:
    # order-4 quadrature: the column-step contract under test (finiteness,
    # warm start, sedimentation transport) is order-independent, and the
    # reduced order keeps the two shared compiles fast on the CPU test
    # backend (order accuracy itself is certified by the quadrature
    # ladder; GL-8 was ~37 s of cold-suite compile here)
    @staticmethod
    def _mp():
        from cloudmicrophysics_tpu.parameters import microphysics_2m_params

        return microphysics_2m_params(with_ice=True, quadrature_order=4)

    @staticmethod
    def _step(state, guess=None, dt=1.0, dz=100.0):
        # dt/dz ride as traced scalars so every test in the class shares
        # the same two compiled programs (same state shape)
        from cloudmicrophysics_tpu.models.column import step_column_p3

        if not hasattr(TestColumnP3, "_step_jit"):
            mp = TestColumnP3._mp()
            TestColumnP3._step_jit = jax.jit(
                lambda s, g, dt, dz: step_column_p3(s, mp, TPS, dt, dz, g),
                static_argnames=())
            TestColumnP3._step_jit_cold = jax.jit(
                lambda s, dt, dz: step_column_p3(s, mp, TPS, dt, dz))
        if guess is None:
            return TestColumnP3._step_jit_cold(state, dt, dz)
        return TestColumnP3._step_jit(state, guess, dt, dz)

    def _state(self, ncol=4, nlev=8):
        f = lambda v: jnp.full((ncol, nlev), v, jnp.float32)
        from cloudmicrophysics_tpu.models.column import ColumnStateP3

        return ColumnStateP3(
            rho=f(1.1), T=f(263.0), q_tot=f(6e-3), q_lcl=f(1e-3),
            n_lcl=f(9e7), q_rai=f(5e-4), n_rai=f(9e5), q_ice=f(5e-4),
            n_ice=f(1e5), q_rim=f(1e-4), b_rim=f(2e-7))

    def test_step_runs_and_stays_finite(self):
        st = self._state()
        new, loglam = self._step(st)
        assert np.isfinite(np.asarray(loglam)).all()
        for name in new._fields:
            v = np.asarray(getattr(new, name))
            assert np.isfinite(v).all(), name
            if name not in ("rho", "T"):
                assert (v >= 0).all(), name
        # rime mass never exceeds total ice mass
        assert (np.asarray(new.q_rim) <= np.asarray(new.q_ice) + 1e-12).all()

    def test_shared_aux_matches_internal(self):
        # the step-shared P3StepAux context (one sanitized state + node
        # table for tendencies AND sedimentation velocities) must be
        # bit-identical to letting the tendency assembly build its own
        from cloudmicrophysics_tpu.models.p3_tendencies import p3_step_aux
        from cloudmicrophysics_tpu.models.tendencies import (
            bulk_tendencies_2m,
        )

        mp = self._mp()
        f = lambda v: jnp.full((8,), v, jnp.float32)
        rho = f(1.1)
        kw = dict(q_ice=f(5e-4), n_ice=f(1e5), q_rim=f(1e-4),
                  b_rim=f(2e-7), log_lambda=f(9.0))
        args = (mp, TPS, rho, f(263.0), f(6e-3), f(1e-3), f(9e7),
                f(5e-4), f(9e5))
        aux = p3_step_aux(mp, rho, kw["q_ice"], kw["n_ice"], kw["q_rim"],
                          kw["b_rim"], kw["log_lambda"])
        internal = bulk_tendencies_2m(*args, **kw)
        external = bulk_tendencies_2m(*args, **kw, p3_aux=aux)
        for name, a, b in zip(internal._fields, internal, external):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=name)

    def test_warm_start_matches_cold_start(self):
        # warm-start contract (reference
        # test/p3_shape_solver_warmstart_tests.jl:22-90): any guess must
        # reproduce the cold-start step to rtol 1e-3 (F32)
        st = self._state()
        st1, loglam1 = self._step(st)
        cold, _ = self._step(st1)
        warm, _ = self._step(st1, loglam1)
        for name in cold._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(warm, name)),
                np.asarray(getattr(cold, name)), rtol=1e-3, atol=1e-12,
                err_msg=name)

    def test_ice_sediments_downward(self):
        # default (4, 8) state so the class's shared compiled programs are
        # reused (dt/dz are traced scalars — no extra compile)
        st = self._state()
        mask = np.zeros((4, 8), np.float32)
        mask[:, 5:] = 1.0  # ice only in the top levels; cold: no melt
        st = st._replace(
            T=jnp.full((4, 8), 250.0, jnp.float32),
            q_ice=jnp.asarray(2e-3 * mask),
            n_ice=jnp.asarray(5e5 * mask),
            q_rim=jnp.asarray(5e-4 * mask),
            b_rim=jnp.asarray(1e-6 * mask),
            q_rai=jnp.zeros((4, 8), jnp.float32),
            n_rai=jnp.zeros((4, 8), jnp.float32),
        )
        new, guess = self._step(st, dt=5.0, dz=50.0)
        for _ in range(4):
            new, guess = self._step(new, guess, dt=5.0, dz=50.0)
        before = np.asarray(st.q_ice)[0, :5].sum()
        after = np.asarray(new.q_ice)[0, :5].sum()
        assert after > before  # ice mass moved into the lower levels


class TestColumn2M:
    def test_step_column_2m_conserves_and_rains(self):
        import numpy as np

        from cloudmicrophysics_tpu.models.column import (
            ColumnState2M,
            step_column_2m,
        )
        from cloudmicrophysics_tpu.parameters import (
            ThermodynamicsParameters,
            microphysics_2m_params,
        )

        tps = ThermodynamicsParameters()
        mp = microphysics_2m_params()
        ncol, nlev = 4, 16
        f = lambda v: jnp.full((ncol, nlev), v, jnp.float64)
        st = ColumnState2M(rho=f(1.1), T=f(288.0), q_tot=f(7e-3),
                           q_lcl=f(1.5e-3), n_lcl=f(9e7),
                           q_rai=f(5e-4), n_rai=f(9e5))
        out = st
        for _ in range(20):
            out = step_column_2m(out, mp, tps, 1.0, 100.0)
        # autoconversion + accretion moved liquid into rain;
        # sedimentation moved rain downward (level 0 gains from above)
        assert float(out.q_rai[0, nlev // 2]) != float(st.q_rai[0, 0])
        assert float(jnp.min(out.q_lcl)) >= 0
        assert float(jnp.min(out.n_rai)) >= 0
        # liquid decreased (acnv+accr), numbers finite
        assert float(out.q_lcl[0, 5]) < 1.5e-3
        assert np.isfinite(np.asarray(out.T)).all()

    def test_chunked_cells_matches_flat_on_column_step(self):
        # perf.chunked_cells splits the leading (ncol) axis; the column
        # step is column-local so the chunked result is bit-identical
        import numpy as np

        from cloudmicrophysics_tpu.models.column import (
            ColumnState2M,
            step_column_2m,
        )
        from cloudmicrophysics_tpu.parameters import (
            ThermodynamicsParameters,
            microphysics_2m_params,
        )
        from cloudmicrophysics_tpu.perf import chunked_cells

        tps = ThermodynamicsParameters()
        mp = microphysics_2m_params()
        ncol, nlev = 8, 16
        rng = np.random.default_rng(3)
        f = lambda s: jnp.asarray(s * (1 + 0.1 * rng.random((ncol, nlev))),
                                  jnp.float64)
        st = ColumnState2M(rho=f(1.1), T=f(288.0), q_tot=f(7e-3),
                           q_lcl=f(1.5e-3), n_lcl=f(9e7),
                           q_rai=f(5e-4), n_rai=f(9e5))
        step = lambda s: step_column_2m(s, mp, tps, 1.0, 100.0)
        flat = jax.jit(step)(st)
        chk = jax.jit(chunked_cells(step, 4))(st)
        for k, a, b in zip(flat._fields, flat, chk):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=k)

    @pytest.mark.slow
    def test_col_chunks_matches_flat_p3(self):
        # the production col_chunks kwarg on the P3 column step (GL-4
        # keeps the compile small; covers the loglambda=None cold start
        # and the warm-started second step). Slow tier: two fresh P3
        # column compiles (~25 s) for a wrapper whose bit-identity is
        # already pinned on the 2M step in the default tier.
        import numpy as np

        from cloudmicrophysics_tpu.models.column import (
            ColumnStateP3,
            step_column_p3,
        )
        from cloudmicrophysics_tpu.parameters import (
            ThermodynamicsParameters,
            microphysics_2m_params,
        )

        tps = ThermodynamicsParameters()
        mp = microphysics_2m_params(with_ice=True, quadrature_order=4)
        fc = lambda v: jnp.full((8, 8), v, jnp.float32)
        st = ColumnStateP3(rho=fc(1.1), T=fc(263.0), q_tot=fc(6e-3),
                           q_lcl=fc(1e-3), n_lcl=fc(9e7), q_rai=fc(5e-4),
                           n_rai=fc(9e5), q_ice=fc(5e-4), n_ice=fc(1e5),
                           q_rim=fc(1e-4), b_rim=fc(2e-7))
        flat, llf = jax.jit(
            lambda x: step_column_p3(x[0], mp, tps, 1.0, 100.0, x[1]))(
                (st, None))
        j = jax.jit(lambda x: step_column_p3(x[0], mp, tps, 1.0, 100.0,
                                             x[1], col_chunks=4))
        chk, llc = j((st, None))
        np.testing.assert_allclose(np.asarray(llc), np.asarray(llf),
                                   rtol=2e-6)
        for k, a, b in zip(flat._fields, flat, chk):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-6, atol=1e-30, err_msg=k)
        chk2, _ = j((chk, llc))    # warm-started second step
        assert np.isfinite(np.asarray(chk2.q_ice)).all()
