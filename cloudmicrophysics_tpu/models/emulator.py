"""ML emulator hook for ARG aerosol activation.

JAX equivalent of ``/root/reference/ext/EmulatorModelsExt.jl``:
three interchangeable regressor families substitute for the ARG
parameterization behind the same ``N_activated_per_mode`` API — a flax
MLP, an exact-GP/kernel-ridge regressor, and gradient-boosted oblivious
trees (the reference swaps NN / GaussianProcess / EvoTree MLJ machines
the same way) — with the reference's mode-permutation trick (the model
predicts the first mode's activated fraction; other modes are predicted
by swapping them into the first slot).

Also provides the training-data generation pipeline mirrored from
``ext/Common.jl:30-60`` (sampling (mode parameters, w, T, p) and labeling
with the ARG parameterization) and a simple optax training loop.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

try:
    import flax.linen as nn
    import optax

    HAVE_FLAX = True
except ImportError:  # pragma: no cover
    HAVE_FLAX = False

from ..ops import aerosol_activation as AA
from ..parameters.aerosol import AerosolDistribution, ModeKappa

__all__ = ["ActivationMLP", "GPRegressor", "BoostedTreesRegressor",
           "emulator_features",
           "generate_training_data", "generate_parcel_training_data",
           "train_emulator", "train_emulator_gp", "train_emulator_trees",
           "N_activated_per_mode_emulated"]

if HAVE_FLAX:

    class ActivationMLP(nn.Module):
        """MLP predicting the activated fraction of the first mode."""

        hidden: Sequence[int] = (64, 64)

        @nn.compact
        def __call__(self, x):
            for h in self.hidden:
                x = nn.relu(nn.Dense(h)(x))
            return nn.sigmoid(nn.Dense(1)(x))[..., 0]

else:  # pragma: no cover

    class ActivationMLP:  # type: ignore[no-redef]
        def __init__(self, *a, **k):
            raise ImportError("flax is required for the activation emulator")


class GPRegressor:
    """Gaussian-process (kernel-ridge) regressor with an RBF kernel.

    Second model family behind the activation API, mirroring the
    reference's MLJ GaussianProcess machine
    (``/root/reference/ext/EmulatorModelsExt.jl:32-67`` swaps GP / NN /
    EvoTree machines behind the same ``N_activated_per_mode`` call).
    Exposes the same ``apply(params, X)`` protocol as a flax module, so
    :func:`N_activated_per_mode_emulated` works with either family.

    The prediction is one ``K(X*, Xtrain) @ alpha`` matmul, so inference
    batches are cheap on an accelerator.
    """

    def __init__(self, lengthscale=1.0, signal_var=1.0, noise=1e-4):
        self.lengthscale = float(lengthscale)
        self.signal_var = float(signal_var)
        self.noise = float(noise)

    def _k(self, A, B):
        d2 = jnp.sum((A[:, None, :] - B[None, :, :]) ** 2, axis=-1)
        return self.signal_var * jnp.exp(-0.5 * d2 / self.lengthscale**2)

    def fit(self, X, y):
        """Exact GP regression fit: returns the params pytree
        ``{X_train, alpha, y_mean, x_mean, x_std}`` with
        ``alpha = (K + noise I)^-1 y``. Features are standardized
        internally (stored in the params) so the isotropic RBF
        lengthscale is meaningful across mixed-scale features."""
        X = jnp.asarray(X, jnp.float32)
        y = jnp.asarray(y, jnp.float32)
        x_mean = jnp.mean(X, axis=0)
        x_std = jnp.std(X, axis=0) + 1e-8
        Xs = (X - x_mean) / x_std
        y_mean = jnp.mean(y)
        K = self._k(Xs, Xs) + self.noise * jnp.eye(X.shape[0],
                                                   dtype=X.dtype)
        L = jax.scipy.linalg.cholesky(K, lower=True)
        alpha = jax.scipy.linalg.cho_solve((L, True), y - y_mean)
        return {"X_train": Xs, "alpha": alpha, "y_mean": y_mean,
                "x_mean": x_mean, "x_std": x_std}

    def apply(self, params, X):
        X = jnp.asarray(X, jnp.float32)
        Xs = (X - params["x_mean"]) / params["x_std"]
        return self._k(Xs, params["X_train"]) @ params["alpha"] \
            + params["y_mean"]


class BoostedTreesRegressor:
    """Gradient-boosted OBLIVIOUS decision trees — third model family
    behind the activation API (the reference swaps GP / NN / **EvoTree**
    machines behind ``N_activated_per_mode``,
    ``/root/reference/ext/EmulatorModelsExt.jl:32-67``).

    Oblivious (CatBoost-style) trees use ONE (feature, threshold) split
    per level, shared across the whole level, so a depth-``d`` tree is
    just ``d`` comparisons and a ``2^d``-leaf lookup. That structure is
    what makes tree inference vectorize: for a whole forest the leaf
    index is a batched bit-pack (pure vector compares + shifts, no
    per-node pointer chasing) and the leaf lookup is one
    ``take_along_axis`` over a ``(n_trees, 2^d)`` table — fully jit/vmap
    compatible, no host callbacks. Fitting runs host-side in NumPy
    (level-wise greedy over per-feature quantile candidate thresholds,
    exact SSE scoring via ``bincount``), mirroring the reference's
    host-side MLJ ``fit!``; only the fitted arrays ship to device.

    Exposes the same ``apply(params, X)`` protocol as the other families.
    """

    def __init__(self, n_trees=200, depth=4, learning_rate=0.1,
                 n_thresholds=15, l2=1.0):
        self.n_trees = int(n_trees)
        self.depth = int(depth)
        self.learning_rate = float(learning_rate)
        self.n_thresholds = int(n_thresholds)
        self.l2 = float(l2)

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        n, F = X.shape
        # per-feature candidate thresholds at interior quantiles
        qs = np.linspace(0, 1, self.n_thresholds + 2)[1:-1]
        cand = np.quantile(X, qs, axis=0)            # (n_thr, F)
        # precompute all candidate split bits once: (n, n_thr, F)
        bits_all = X[:, None, :] > cand[None, :, :]

        bias = float(np.mean(y))
        resid = y - bias
        feats = np.zeros((self.n_trees, self.depth), np.int32)
        thrs = np.zeros((self.n_trees, self.depth), np.float32)
        leaves = np.zeros((self.n_trees, 2 ** self.depth), np.float32)
        for t in range(self.n_trees):
            group = np.zeros(n, np.int64)
            for lvl in range(self.depth):
                n_groups = 2 ** (lvl + 1)
                best = (np.inf, 0, 0)
                for f in range(F):
                    for k in range(self.n_thresholds):
                        g = group * 2 + bits_all[:, k, f]
                        s = np.bincount(g, weights=resid,
                                        minlength=n_groups)
                        c = np.bincount(g, minlength=n_groups)
                        # SSE after fitting group means, up to const:
                        # -(sum_g s_g^2 / (c_g + l2))
                        score = -np.sum(s * s / (c + self.l2))
                        if score < best[0]:
                            best = (score, f, k)
                _, f, k = best
                feats[t, lvl] = f
                thrs[t, lvl] = cand[k, f]
                group = group * 2 + bits_all[:, k, f]
            s = np.bincount(group, weights=resid,
                            minlength=2 ** self.depth)
            c = np.bincount(group, minlength=2 ** self.depth)
            leaf = self.learning_rate * s / (c + self.l2)
            leaves[t] = leaf
            resid = resid - leaf[group]
        return {"features": jnp.asarray(feats),
                "thresholds": jnp.asarray(thrs),
                "leaves": jnp.asarray(leaves),
                "bias": jnp.asarray(bias, jnp.float32)}

    def apply(self, params, X):
        X = jnp.asarray(X, jnp.float32)
        squeeze = X.ndim == 1
        if squeeze:
            X = X[None]
        # (B, n_trees, depth) feature gather -> bit-pack -> leaf lookup
        xf = X[:, params["features"]]                # (B, T, D)
        bits = (xf > params["thresholds"][None]).astype(jnp.int32)
        pows = 2 ** jnp.arange(self.depth - 1, -1, -1, dtype=jnp.int32)
        idx = jnp.sum(bits * pows, axis=-1)          # (B, T)
        vals = jnp.take_along_axis(
            jnp.broadcast_to(params["leaves"][None], idx.shape
                             + (params["leaves"].shape[-1],)),
            idx[..., None], axis=-1)[..., 0]
        out = params["bias"] + jnp.sum(vals, axis=-1)
        return out[0] if squeeze else out


def train_emulator_trees(X, y, n_trees=200, depth=4, learning_rate=0.1):
    """Fit the boosted-trees family; same result shape as
    :func:`train_emulator` / :func:`train_emulator_gp`."""
    model = BoostedTreesRegressor(n_trees=n_trees, depth=depth,
                                  learning_rate=learning_rate)
    params = model.fit(X, y)
    pred = model.apply(params, jnp.asarray(X, jnp.float32))
    rmse = float(jnp.sqrt(jnp.mean((pred - jnp.asarray(y, jnp.float32))
                                   ** 2)))
    return model, params, rmse


def train_emulator_gp(X, y, lengthscale=2.0, signal_var=1.0, noise=1e-2):
    """Fit the GP family; returns ``(model, params, train_rmse)`` with the
    same shape of result as :func:`train_emulator`."""
    model = GPRegressor(lengthscale=lengthscale, signal_var=signal_var,
                        noise=noise)
    params = model.fit(X, y)
    pred = model.apply(params, X)
    rmse = float(jnp.sqrt(jnp.mean((pred - jnp.asarray(y, jnp.float32))
                                   ** 2)))
    return model, params, rmse


def emulator_features(ad, ap, w, T, p):
    """Feature vector per mode-permutation: (N, r_dry, stdev, hygro) per
    mode + (w, T, p), with log-scaled magnitudes."""
    hygro = AA.mean_hygroscopicity_parameter(ap, ad)
    feats = []
    for mode, h in zip(ad.modes, hygro):
        # normalized: log-number ~[6.5, 9.5]*ln10, log-radius ~[-19, -15]
        feats += [(jnp.log(jnp.asarray(mode.N)) - 18.0) / 4.0,
                  (jnp.log(jnp.asarray(mode.r_dry)) + 17.0) / 2.0,
                  jnp.asarray(mode.stdev) - 1.9, jnp.asarray(h)]
    feats += [jnp.log(jnp.asarray(w)), (jnp.asarray(T) - 285.0) / 15.0,
              (jnp.asarray(p) - 8.5e4) / 2e4]
    return jnp.stack(jnp.broadcast_arrays(*feats), axis=-1)


def generate_training_data(ap, aip, tps, n_samples=2048, n_modes=2, seed=0):
    """Sample (2-mode kappa aerosol, w, T, p) and label with the ARG
    parameterization (reference ext/Common.jl:30-60).

    Fully vectorized: every sample's mode parameters ride as array leaves
    of ONE stacked :class:`AerosolDistribution`, so the whole dataset is a
    single batched ARG evaluation (one fused device call), not a Python
    loop over samples.
    """
    from ..ops import thermo as TDI

    rng = np.random.default_rng(seed)
    A = lambda x: jnp.asarray(x, jnp.float64)
    r_dry = 10 ** rng.uniform(-8.2, -6.5, (n_modes, n_samples))
    stdev = rng.uniform(1.4, 2.4, (n_modes, n_samples))
    N_m = 10 ** rng.uniform(6.5, 9.5, (n_modes, n_samples))
    kappa = rng.uniform(0.1, 1.2, (n_modes, n_samples))
    w = A(10 ** rng.uniform(-1.5, 0.7, n_samples))
    T = A(rng.uniform(270.0, 300.0, n_samples))
    p = A(rng.uniform(7e4, 1.02e5, n_samples))

    modes = tuple(
        ModeKappa(r_dry=A(r_dry[m]), stdev=A(stdev[m]), N=A(N_m[m]),
                  vol_mix_ratio=(1.0,), mass_mix_ratio=(1.0,),
                  molar_mass=(0.13214,), kappa=(A(kappa[m]),))
        for m in range(n_modes))
    ad = AerosolDistribution(modes=modes)

    @jax.jit
    def label(ad, w, T, p):
        # saturated humid state, no condensate (ARG assumption)
        p_vs = TDI.saturation_vapor_pressure_over_liquid(tps, T)
        q_tot = 1 / (1 - tps.Rv_over_Rd * (p_vs - p) / p_vs)
        n_act = AA.N_activated_per_mode(ap, ad, aip, tps, T, p, w, q_tot,
                                        0.0, 0.0)
        return emulator_features(ad, ap, w, T, p), n_act[0] / ad.modes[0].N

    X, y = label(ad, w, T, p)
    return np.asarray(X), np.asarray(y)


def generate_parcel_training_data(ap, aip, tps, n_samples=256, n_modes=2,
                                  seed=0, t_end=20.0, dt=0.2,
                                  return_arg_labels=False):
    """Parcel-ensemble training data: labels come from parcel-model
    supersaturation maxima, not from the ARG closed form.

    Mirrors the reference's parcel-driven dataset pipeline
    (``/root/reference/ext/Common.jl:30-60``: features are per-mode
    ``(N, r_dry, stdev, kappa)`` + ``(w, T, p)``, the label is
    ``mode_1_act_frac_S_interp`` — the mode-1 activated fraction evaluated
    at the parcel's S_max). Here each sample runs a liquid-only
    activation+condensation parcel (vmapped over the ensemble — one fused
    device batch), S_max is taken over the trajectory, and the label is the
    erf activated fraction of mode 1 at that S_max.
    """
    from ..utils.param import replace as preplace
    from . import parcel as PM

    rng = np.random.default_rng(seed)
    F = jnp.float32

    # sampled per-ensemble-member scalars
    r_dry = 10 ** rng.uniform(-8.2, -6.8, (n_samples, n_modes))
    stdev = rng.uniform(1.4, 2.4, (n_samples, n_modes))
    N_m = 10 ** rng.uniform(6.5, 9.0, (n_samples, n_modes))
    kappa = rng.uniform(0.1, 1.2, (n_samples, n_modes))
    w = 10 ** rng.uniform(-1.0, 0.7, n_samples)
    T0 = rng.uniform(270.0, 300.0, n_samples)
    p0 = rng.uniform(7e4, 1.02e5, n_samples)

    from ..parameters.aerosol_species import Sulfate

    base = PM.parcel_params(aerosol_act="AeroAct",
                            condensation_growth="Condensation",
                            aerosol=Sulfate(), aero_sigma_g=2.0,
                            const_dt=dt)

    from ..ops import thermo as TDI

    def TDI_sat(tps, T):
        return TDI.saturation_vapor_pressure_over_liquid(tps,
                                                         jnp.float64(T))

    def one(r_nuc, sigma_g, N_tot, kap, w_i, T_i, p_i):
        # parcel ICs: just-saturated, no condensate (ARG assumption)
        rho = TDI.air_density(tps, T_i, p_i, 0.0, 0.0, 0.0)
        p_vs = TDI.saturation_vapor_pressure_over_liquid(tps, T_i)
        q_vap = TDI.p2q(tps, T_i, rho, p_vs)
        ic = PM.ParcelState(S_l=F(1.0) + F(1e-4), p_air=p_i, T=T_i,
                            q_vap=q_vap, q_liq=F(0.0), q_ice=F(0.0),
                            N_aer=N_tot, N_liq=F(0.0), N_ice=F(0.0),
                            ln_inpc=F(0.0))
        pp = preplace(base, w=w_i, r_nuc=r_nuc, aero_sigma_g=sigma_g,
                      N_aer_act=N_tot,
                      aerosol=preplace(base.aerosol, kappa=kap))
        traj = PM.run_parcel(ic, 0.0, t_end, pp)
        return jnp.max(traj.S_l) - 1.0

    args = [jnp.asarray(a, F) for a in
            (r_dry[:, 0], stdev[:, 0], N_m.sum(axis=1), kappa[:, 0],
             w, T0, p0)]
    S_max = np.asarray(jax.jit(jax.vmap(one))(*args))

    X, y, y_arg = [], [], []
    from jax.scipy.special import erf as jerf

    for s in range(n_samples):
        modes = tuple(
            ModeKappa(r_dry=float(r_dry[s, m]), stdev=float(stdev[s, m]),
                      N=float(N_m[s, m]), vol_mix_ratio=(1.0,),
                      mass_mix_ratio=(1.0,), molar_mass=(0.13214,),
                      kappa=(float(kappa[s, m]),))
            for m in range(n_modes))
        ad = AerosolDistribution(modes=modes)
        X.append(np.asarray(emulator_features(ad, ap, w[s], T0[s], p0[s])))
        # mode-1 activated fraction at the parcel S_max (the reference's
        # S-interp label)
        sm1 = AA.critical_supersaturation(ap, ad, jnp.float64(T0[s]))[0]
        smax = max(float(S_max[s]), 1e-10)
        u = 2 * np.log(float(sm1) / smax) / 3 / np.sqrt(2.0) \
            / np.log(stdev[s, 0])
        y.append(0.5 * (1 - float(jerf(u))))
        if return_arg_labels:
            # ARG closed-form label for the SAME configuration (used to
            # validate the parcel labels against the parameterization)
            p_vs = float(TDI_sat(tps, T0[s]))
            q_tot = 1 / (1 - tps.Rv_over_Rd * (p_vs - p0[s]) / p_vs)
            n_act = AA.N_activated_per_mode(
                ap, ad, aip, tps, jnp.float64(T0[s]), jnp.float64(p0[s]),
                jnp.float64(w[s]), jnp.float64(q_tot), 0.0, 0.0)
            y_arg.append(float(n_act[0]) / modes[0].N)
    if return_arg_labels:
        return np.stack(X), np.asarray(y), np.asarray(y_arg)
    return np.stack(X), np.asarray(y)


def train_emulator(X, y, hidden=(64, 64), n_steps=2000, lr=1e-3, seed=0):
    """Train the MLP with optax Adam; returns (model, params)."""
    model = ActivationMLP(hidden=hidden)
    X = jnp.asarray(X, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), X[:1])
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            pred = model.apply(p, X)
            return jnp.mean((pred - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    for _ in range(n_steps):
        params, opt_state, loss = step(params, opt_state)
    return model, params, float(loss)


def N_activated_per_mode_emulated(model, params, ap, ad, aip, tps,
                                  T, p, w, q_tot, q_liq, q_ice):
    """Emulated activated number per mode (reference
    ext/EmulatorModelsExt.jl:32-67): predict mode 1's activated fraction,
    permuting each mode into the first slot."""
    n_modes = len(ad.modes)
    out = []
    for i in range(n_modes):
        perm = list(range(n_modes))
        perm[0], perm[i] = perm[i], perm[0]
        ad_p = AerosolDistribution(modes=tuple(ad.modes[j] for j in perm))
        x = emulator_features(ad_p, ap, w, T, p)
        frac = jnp.clip(model.apply(params, x[None])[0], 0.0, 1.0)
        out.append(frac * ad.modes[i].N)
    return tuple(out)
