"""Calibration (EKI) + emulator + sandbox tests.

Mirrors the reference's perfect-model recovery workflow
(/root/reference/test/ice_nucleation_calibration.jl) and the emulator
training harness (test/aerosol_activation_emulators.jl)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cloudmicrophysics_tpu.models import calibration as CAL
from cloudmicrophysics_tpu.models import parcel as PM
from cloudmicrophysics_tpu.ops import thermo as TDI
from cloudmicrophysics_tpu.parameters import (
    AirProperties,
    ThermodynamicsParameters,
)

TPS = ThermodynamicsParameters()
F = jnp.float64

_EMULATOR_DATA = {}


def _emulator_dataset():
    """One shared (train, val) ARG dataset for all emulator tests — the
    batched label graph compiles once per (shape, dtype), so every test
    slicing from the same arrays avoids a fresh multi-minute XLA compile.
    """
    if "train" not in _EMULATOR_DATA:
        from cloudmicrophysics_tpu.models import emulator as EM
        from cloudmicrophysics_tpu.parameters.aerosol import (
            AerosolActivationParameters,
        )

        ap = AerosolActivationParameters()
        aip = AirProperties()
        _EMULATOR_DATA["ap"], _EMULATOR_DATA["aip"] = ap, aip
        _EMULATOR_DATA["train"] = EM.generate_training_data(
            ap, aip, TPS, n_samples=2048, seed=1)
        _EMULATOR_DATA["val"] = EM.generate_training_data(
            ap, aip, TPS, n_samples=2048, seed=2)
    return _EMULATOR_DATA


class TestEKI:
    def test_linear_recovery(self):
        # EKI recovers parameters of a linear forward map exactly
        A = jnp.asarray(np.random.default_rng(0).normal(size=(6, 2)))
        theta_true = jnp.asarray([2.0, -1.5])
        y = A @ theta_true

        def forward(thetas):
            return thetas @ A.T

        res = CAL.eki_calibrate(forward, [0.0, 0.0], [2.0, 2.0], y,
                                np.eye(6) * 1e-6, n_ensemble=30,
                                n_iterations=10)
        np.testing.assert_allclose(np.asarray(res.theta), [2.0, -1.5],
                                   atol=0.05)
        assert float(res.errors[-1]) < float(res.errors[0])

    def test_abifm_perfect_model_recovery(self):
        # perfect-model: generate observations with known (m, c), recover
        # them through the full vmapped parcel forward map
        import dataclasses

        from cloudmicrophysics_tpu.parameters.aerosol_species import Illite

        T0, p0, Nl, r0 = 251.0, 80000.0, 1e8, 1e-6
        e = float(TDI.saturation_vapor_pressure_over_liquid(TPS, F(T0)))
        md = (p0 - e) / TPS.R_d / T0
        mv = e / TPS.R_v / T0
        ml = Nl * 4 / 3 * np.pi * 1000 * r0**3
        ic = PM.ParcelState(
            S_l=F(1.0), p_air=F(p0), T=F(T0), q_vap=F(mv / (md + mv + ml)),
            q_liq=F(ml / (md + mv + ml)), q_ice=F(0.0), N_aer=F(0.0),
            N_liq=F(Nl), N_ice=F(0.0), ln_inpc=F(0.0))
        kwargs = dict(heterogeneous="ABIFM",
                      condensation_growth="Condensation",
                      const_dt=1.0, w=0.5)

        m_true, c_true = 54.48, -10.67
        aerosol = dataclasses.replace(Illite(), ABIFM_m=m_true,
                                      ABIFM_c=c_true)
        params = PM.parcel_params(aerosol=aerosol, **kwargs)
        traj = PM.run_parcel(ic, 0.0, 60.0, params)
        frozen = np.asarray(traj.N_ice / np.maximum(
            np.asarray(traj.N_liq + traj.N_ice), 1.0))
        idx = np.linspace(0, len(frozen) - 1, 5).astype(int)
        y_obs = frozen[idx]
        assert y_obs[-1] > 0  # some freezing happened

        res = CAL.calibrate_abifm(
            ic, 60.0, kwargs, y_obs, noise_std=0.02,
            prior_mean=(50.0, -9.0), prior_std=(8.0, 2.0),
            n_ensemble=20, n_iterations=6)
        m_fit, c_fit = float(res.theta[0]), float(res.theta[1])
        # (m, c) are correlated through J; accept recovery of the observed
        # freezing behavior: rerun with fitted params and compare
        import dataclasses as dc

        aero_fit = dc.replace(Illite(), ABIFM_m=m_fit, ABIFM_c=c_fit)
        traj_fit = PM.run_parcel(
            ic, 0.0, 60.0, PM.parcel_params(aerosol=aero_fit, **kwargs))
        frozen_fit = np.asarray(traj_fit.N_ice / np.maximum(
            np.asarray(traj_fit.N_liq + traj_fit.N_ice), 1.0))[idx]
        np.testing.assert_allclose(frozen_fit, y_obs, atol=0.05)
        assert float(res.errors[-1]) <= float(res.errors[0])


class TestEmulator:
    def test_train_and_predict(self):
        pytest.importorskip("flax")
        from cloudmicrophysics_tpu.models import emulator as EM
        from cloudmicrophysics_tpu.parameters.aerosol import (
            AerosolActivationParameters,
        )

        data = _emulator_dataset()
        ap, aip = data["ap"], data["aip"]
        X, y = data["train"]
        X, y = X[:512], y[:512]
        model, params, loss = EM.train_emulator(X, y, hidden=(64, 64),
                                                n_steps=2000)
        assert loss < 0.01
        # prediction through the API reproduces ARG within tolerance on a
        # fresh sample (reference emulator harness targets ~0.1 rmse)
        X2, y2 = data["val"]
        X2, y2 = X2[:64], y2[:64]
        pred = np.asarray(model.apply(params, jnp.asarray(X2, jnp.float32)))
        assert np.sqrt(np.mean((pred - y2) ** 2)) < 0.1
        # the mode-permutation API returns per-mode numbers
        from cloudmicrophysics_tpu.parameters.aerosol import (
            AerosolDistribution,
            ModeKappa,
        )

        mode = lambda N: ModeKappa(r_dry=5e-8, stdev=2.0, N=N,
                                   vol_mix_ratio=(1.0,),
                                   mass_mix_ratio=(1.0,),
                                   molar_mass=(0.13214,), kappa=(0.53,))
        ad = AerosolDistribution(modes=(mode(1e8), mode(5e8)))
        out = EM.N_activated_per_mode_emulated(
            model, params, ap, ad, aip, TPS, 290.0, 9e4, 1.0,
            0.01, 0.0, 0.0)
        assert len(out) == 2
        assert 0 <= float(out[0]) <= 1e8 and 0 <= float(out[1]) <= 5e8


class TestEmulatorGP:
    def test_gp_family_and_api(self):
        # second regressor family behind the same activation API
        # (reference ext/EmulatorModelsExt.jl:32-67 swaps GP/NN/EvoTree
        # machines; harness tolerance from
        # test/aerosol_activation_emulators.jl:10-74)
        from cloudmicrophysics_tpu.models import emulator as EM
        from cloudmicrophysics_tpu.parameters.aerosol import (
            AerosolActivationParameters,
            AerosolDistribution,
            ModeKappa,
        )

        data = _emulator_dataset()
        ap, aip = data["ap"], data["aip"]
        X, y = data["train"]
        model, params, rmse = EM.train_emulator_gp(X, y)
        assert rmse < 0.05
        X2, y2 = data["val"]
        X2, y2 = X2[:64], y2[:64]
        pred = np.asarray(model.apply(params, X2))
        assert np.sqrt(np.mean((pred - y2) ** 2)) < 0.1
        mode = lambda N: ModeKappa(r_dry=5e-8, stdev=2.0, N=N,
                                   vol_mix_ratio=(1.0,),
                                   mass_mix_ratio=(1.0,),
                                   molar_mass=(0.13214,), kappa=(0.53,))
        ad = AerosolDistribution(modes=(mode(1e8), mode(5e8)))
        out = EM.N_activated_per_mode_emulated(
            model, params, ap, ad, aip, TPS, 290.0, 9e4, 1.0,
            0.01, 0.0, 0.0)
        assert len(out) == 2
        assert 0 <= float(out[0]) <= 1e8 and 0 <= float(out[1]) <= 5e8

    def test_trees_family_and_api(self):
        # THIRD regressor family: gradient-boosted oblivious trees — the
        # JAX analog of the reference's EvoTree machine
        # (ext/EmulatorModelsExt.jl:32-67); same ~0.1-rmse harness gate
        # as test/aerosol_activation_emulators.jl:10-74
        from cloudmicrophysics_tpu.models import emulator as EM
        from cloudmicrophysics_tpu.ops import aerosol_activation as AA
        from cloudmicrophysics_tpu.parameters.aerosol import (
            AerosolDistribution,
            ModeKappa,
        )

        data = _emulator_dataset()
        ap, aip = data["ap"], data["aip"]
        X, y = data["train"]
        model, params, rmse = EM.train_emulator_trees(
            X, y, n_trees=300, depth=5, learning_rate=0.12)
        assert rmse < 0.05  # train fit
        X2, y2 = data["val"]
        pred = np.asarray(model.apply(params, jnp.asarray(X2, jnp.float32)))
        assert np.sqrt(np.mean((pred - y2) ** 2)) < 0.1

        # emulated-vs-EXACT activation gate through the public API:
        # per-mode activated numbers within 15% of N_tot of the exact ARG
        # values across a few states (reference validation shape)
        mode = lambda N, r: ModeKappa(r_dry=r, stdev=2.0, N=N,
                                      vol_mix_ratio=(1.0,),
                                      mass_mix_ratio=(1.0,),
                                      molar_mass=(0.13214,), kappa=(0.53,))
        for (N1, N2, r, w, T, p) in [
            (1e8, 5e8, 5e-8, 1.0, 290.0, 9e4),
            (5e7, 2e8, 8e-8, 0.5, 283.0, 8.5e4),
            (3e8, 1e8, 4e-8, 2.0, 295.0, 9.5e4),
        ]:
            ad = AerosolDistribution(modes=(mode(N1, r), mode(N2, r)))
            em = EM.N_activated_per_mode_emulated(
                model, params, ap, ad, aip, TPS, T, p, w, 0.01, 0.0, 0.0)
            ex = AA.N_activated_per_mode(ap, ad, aip, TPS, T, p, w,
                                         0.01, 0.0, 0.0)
            for e_i, x_i, N_i in zip(em, ex, (N1, N2)):
                assert abs(float(e_i) - float(x_i)) < 0.15 * N_i, \
                    (N1, N2, r, w, T, p, float(e_i), float(x_i))

    def test_parcel_data_pipeline(self):
        # parcel-ensemble labels (reference ext/Common.jl:30-60): S_max
        # from the parcel trajectory, act frac via the erf formula; the
        # labels must be physical fractions correlated with the ARG ones
        from cloudmicrophysics_tpu.models import emulator as EM
        from cloudmicrophysics_tpu.parameters.aerosol import (
            AerosolActivationParameters,
        )

        ap = AerosolActivationParameters()
        aip = AirProperties()
        X, y, y_arg = EM.generate_parcel_training_data(
            ap, aip, TPS, n_samples=32, seed=3, t_end=10.0, dt=0.5,
            return_arg_labels=True)
        assert X.shape[0] == 32 and y.shape == (32,)
        assert np.all((y >= 0) & (y <= 1))
        assert np.isfinite(X).all()
        assert y.std() > 0.01  # non-degenerate labels
        # parcel labels track the ARG closed form on the SAME configs
        corr = np.corrcoef(y, y_arg)[0, 1]
        assert corr > 0.5


class TestP3Sandbox:
    def test_runs(self):
        from cloudmicrophysics_tpu.models.p3_sandbox import (
            P3SandboxState,
            run_p3_sandbox,
        )
        from cloudmicrophysics_tpu.parameters.aerosol_species import Illite
        from cloudmicrophysics_tpu.parameters.p3 import parameters_p3

        # reference IC (p3_sandbox/p3_sandbox.jl:68-84): slightly
        # supersaturated vapor; immersion freezing is a trickle
        N_l, r_l = 500e3, 1e-6
        q_l = N_l * 4 / 3 * np.pi * r_l**3 * 1000.0 / 1.2
        ic = P3SandboxState(N_ice=F(100e6), q_ice=F(1e-3), q_rim=F(1e-4),
                            B_rim=F(1e-4 / 200))
        traj, thresholds = run_p3_sandbox(
            ic, 0.0, 2.0, 1.0, parameters_p3(), TPS, Illite(),
            T=F(251.0), p_air=F(800e2), q_vap=F(8.1e-4), q_liq=F(q_l),
            N_liq=F(N_l), r_liq=F(r_l))
        # ABIFM at da_w ~ 0.2 freezes O(0.1 /m^3/s): N_ice grows but by
        # far less than one droplet per cm^3
        growth = float(traj.N_ice[-1]) - 100e6
        assert 0 < growth < 1e3
        D_th, D_gr, D_cr, rho_g = thresholds
        assert float(D_th) < float(D_gr) < float(D_cr)


class TestUKI:
    def test_linear_recovery(self):
        # UKI recovers a linear map with a deterministic sigma-point
        # ensemble (2p+1 = 5 members)
        A = jnp.asarray(np.random.default_rng(3).normal(size=(6, 2)))
        theta_true = jnp.asarray([2.0, -1.5])
        y = A @ theta_true

        res = CAL.uki_calibrate(lambda t: t @ A.T, [0.0, 0.0], [2.0, 2.0],
                                y, np.eye(6) * 1e-6, n_iterations=15)
        np.testing.assert_allclose(np.asarray(res.theta), [2.0, -1.5],
                                   atol=0.02)
        assert res.ensemble.shape == (2, 5)
        assert float(res.errors[-1]) < float(res.errors[0])

    def test_abifm_uki_route(self):
        # the UKI route through calibrate_abifm runs and reduces misfit
        import dataclasses

        from cloudmicrophysics_tpu.parameters.aerosol_species import Illite

        T0, p0, Nl, r0 = 251.0, 80000.0, 1e8, 1e-6
        e = float(TDI.saturation_vapor_pressure_over_liquid(TPS, F(T0)))
        md = (p0 - e) / TPS.R_d / T0
        mv = e / TPS.R_v / T0
        ml = Nl * 4 / 3 * np.pi * 1000 * r0**3
        ic = PM.ParcelState(
            S_l=F(1.0), p_air=F(p0), T=F(T0), q_vap=F(mv / (md + mv + ml)),
            q_liq=F(ml / (md + mv + ml)), q_ice=F(0.0), N_aer=F(0.0),
            N_liq=F(Nl), N_ice=F(0.0), ln_inpc=F(0.0))
        kwargs = dict(heterogeneous="ABIFM",
                      condensation_growth="Condensation",
                      const_dt=1.0, w=0.5)
        aerosol = dataclasses.replace(Illite(), ABIFM_m=54.48,
                                      ABIFM_c=-10.67)
        traj = PM.run_parcel(ic, 0.0, 60.0,
                             PM.parcel_params(aerosol=aerosol, **kwargs))
        frozen = np.asarray(traj.N_ice / np.maximum(
            np.asarray(traj.N_liq + traj.N_ice), 1.0))
        idx = np.linspace(0, len(frozen) - 1, 5).astype(int)
        res = CAL.calibrate_abifm(
            ic, 60.0, kwargs, frozen[idx], noise_std=0.02,
            prior_mean=(50.0, -9.0), prior_std=(8.0, 2.0),
            n_iterations=8, method="UKI")
        assert float(res.errors[-1]) <= float(res.errors[0])


class TestArtifacts:
    def test_missing_artifact_error(self, tmp_path, monkeypatch):
        from cloudmicrophysics_tpu.utils import (
            AIDA_ice_nucleation,
            ArtifactMissingError,
        )

        monkeypatch.setenv("CMT_ARTIFACTS_DIR", str(tmp_path))
        with pytest.raises(ArtifactMissingError, match="no network egress"):
            AIDA_ice_nucleation("in05_17_aida.edf")
        # present file resolves
        d = tmp_path / "AIDA_ice_nucleation"
        d.mkdir()
        (d / "in05_17_aida.edf").write_text("data")
        assert AIDA_ice_nucleation("in05_17_aida.edf").read_text() == "data"


class TestAIDA:
    def test_synthetic_chamber_calibration(self, tmp_path):
        # perfect-model through the AIDA file workflow: synthesize an .edf
        # from a known-parameter parcel run, then recover the freezing
        # behavior from the file
        import dataclasses

        from cloudmicrophysics_tpu.models.aida import (
            aida_observations,
            calibrate_abifm_aida,
            unpack_aida_edf,
        )
        from cloudmicrophysics_tpu.parameters.aerosol_species import Illite

        T0, p0, Nl, rl = 251.0, 80000.0, 1e8, 1e-6
        e0 = float(TDI.saturation_vapor_pressure_over_liquid(TPS, F(T0)))
        md = (p0 - e0) / TPS.R_d / T0
        mv = e0 / TPS.R_v / T0
        ml = Nl * 4 / 3 * np.pi * 1000 * rl**3
        ic = PM.ParcelState(
            S_l=F(1.0), p_air=F(p0), T=F(T0), q_vap=F(mv / (md + mv + ml)),
            q_liq=F(ml / (md + mv + ml)), q_ice=F(0.0), N_aer=F(0.0),
            N_liq=F(Nl), N_ice=F(0.0), ln_inpc=F(0.0))
        params = PM.parcel_params(
            aerosol=Illite(), heterogeneous="ABIFM",
            condensation_growth="Condensation", const_dt=1.0, w=0.5)
        traj = PM.run_parcel(ic, 0.0, 120.0, params)

        edf = tmp_path / "synth.edf"
        lines = ["# header"] * 225
        for i in range(121):
            lines.append(
                f"{float(i):.1f} {float(traj.p_air[i]) / 100:.3f} "
                f"{float(traj.T[i]):.3f} {e0:.3f} 0 "
                f"{float(traj.N_ice[i]) / 1e6:.6e}")
        edf.write_text("\n".join(lines) + "\n")

        prof = unpack_aida_edf(edf)
        assert prof.P[0] == pytest.approx(p0)
        obs = aida_observations(prof, 0.0, 120.0, 1e8, n_obs=5)
        assert obs[-1] > obs[0] >= 0

        res = calibrate_abifm_aida(
            prof, 0.0, 120.0, 1e8, Nl, rl, noise_std=0.02,
            prior_mean=(50.0, -9.0), prior_std=(8.0, 2.0),
            n_ensemble=20, n_iterations=6)
        assert float(res.errors[-1]) < 1e-3 * float(res.errors[0])
