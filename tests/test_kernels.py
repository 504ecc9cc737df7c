"""Triton-route column kernels: interpret-mode parity on the CPU, and the
launch shape, lowering and dispatch rules around them.

The kernels apply the same jnp physics to tiles of whole columns, and
take the sedimentation inflow from a second load shifted one level up,
so the contract is close agreement with XLA's fusion of the plain step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cloudmicrophysics_tpu.kernels import (
    step_column_1m_triton,
    step_column_2m_triton,
)
from cloudmicrophysics_tpu.kernels._column import _folded, tile_columns
from cloudmicrophysics_tpu.models.column import (
    ColumnState,
    ColumnState2M,
    step_column_1m,
    step_column_2m,
)
from cloudmicrophysics_tpu.parameters import (
    ThermodynamicsParameters,
    microphysics_1m_params,
    microphysics_2m_params,
    terminal_velocity_params,
)

MP = microphysics_1m_params()
MP2 = microphysics_2m_params()
TPS = ThermodynamicsParameters()
TV = terminal_velocity_params()


def _state(ncol, nlev, dtype=jnp.float32):
    rng = np.random.default_rng(7)
    shape = (ncol, nlev)
    return ColumnState(
        rho=jnp.asarray(np.linspace(1.2, 0.4, nlev)[None, :]
                        * np.ones((ncol, 1)), dtype),
        T=jnp.asarray(np.linspace(300.0, 230.0, nlev)[None, :]
                      * np.ones((ncol, 1)), dtype),
        q_tot=jnp.asarray(1e-2 * rng.random(shape), dtype),
        q_lcl=jnp.asarray(1e-3 * rng.random(shape), dtype),
        q_icl=jnp.asarray(5e-4 * rng.random(shape), dtype),
        q_rai=jnp.asarray(5e-4 * rng.random(shape), dtype),
        q_sno=jnp.asarray(5e-4 * rng.random(shape), dtype),
    )


def _state_2m(ncol, nlev):
    rng = np.random.default_rng(3)
    f = lambda v: jnp.asarray(v * (1 + 0.5 * rng.random((ncol, nlev))),
                              jnp.float32)
    return ColumnState2M(rho=f(1.1), T=f(288.0), q_tot=f(6e-3),
                         q_lcl=f(1e-3), n_lcl=f(9e7), q_rai=f(5e-4),
                         n_rai=f(9e5))


def _assert_close(got, want, rtol, atol):
    for name in want._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=rtol, atol=atol, err_msg=name)


class TestColumn1MTriton:
    @pytest.mark.parametrize("sediment_cloud", [True, False])
    def test_matches_xla_fused_path(self, sediment_cloud):
        # two tiles of 32 columns: the shifted load crosses tile edges
        state = _state(64, 16)
        ref = jax.jit(lambda s: step_column_1m(
            s, MP, TPS, TV, 1.0, 100.0, sediment_cloud=sediment_cloud))(state)
        out = step_column_1m_triton(state, MP, TPS, TV, 1.0, 100.0,
                                    sediment_cloud=sediment_cloud,
                                    interpret=True)
        _assert_close(out, ref, rtol=2e-5, atol=2e-9)

    def test_tiles_are_independent(self):
        # one tile of 32 columns or the same columns as half of a 64-column
        # run: columns never see each other
        state = _state(64, 16)
        a = step_column_1m_triton(state, MP, TPS, TV, 1.0, 100.0,
                                  interpret=True)
        b = step_column_1m_triton(
            jax.tree_util.tree_map(lambda x: x[32:], state),
            MP, TPS, TV, 1.0, 100.0, interpret=True)
        _assert_close(b, jax.tree_util.tree_map(lambda x: x[32:], a),
                      rtol=1e-6, atol=0.0)

    def test_lowers_for_the_gpu(self):
        # the Triton IR is built here; only its compilation needs a GPU
        low = jax.jit(lambda s: step_column_1m_triton(
            s, MP, TPS, TV, 1.0, 100.0)).trace(_state(8, 64)).lower(
                lowering_platforms=("cuda",))
        assert "xla.gpu.triton" in low.as_text()

    def test_needs_interpret_mode_off_the_gpu(self):
        with pytest.raises(ValueError, match="interpret"):
            step_column_1m_triton(_state(8, 16), MP, TPS, TV, 1.0, 100.0)


class TestColumn2MTriton:
    def test_matches_xla_fused_path(self):
        state = _state_2m(64, 16)
        ref = jax.jit(lambda s: step_column_2m(s, MP2, TPS, 1.0, 100.0))(
            state)
        out = step_column_2m_triton(state, MP2, TPS, 1.0, 100.0,
                                    interpret=True)
        _assert_close(out, ref, rtol=2e-5, atol=1e-8)

    def test_lowers_for_the_gpu(self):
        low = jax.jit(lambda s: step_column_2m_triton(
            s, MP2, TPS, 1.0, 100.0)).trace(_state_2m(8, 64)).lower(
                lowering_platforms=("cuda",))
        assert "xla.gpu.triton" in low.as_text()

    def test_impl_pallas_raises_off_the_gpu(self):
        with pytest.raises(ValueError, match="compiles for the GPU"):
            step_column_2m(_state_2m(8, 16), MP2, TPS, 1.0, 100.0,
                           impl="pallas")

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError, match="unknown impl"):
            step_column_2m(_state_2m(8, 16), MP2, TPS, 1.0, 100.0,
                           impl="mosaic")


class TestLaunchShape:
    @pytest.mark.parametrize("ncol, nlev, block", [
        (524288, 128, 4), (1000, 128, 4), (6, 128, 2), (7, 128, 1),
        (64, 16, 32), (3, 1024, 1)])
    def test_tile_columns(self, ncol, nlev, block):
        assert tile_columns(ncol, nlev) == block

    def test_levels_must_be_a_power_of_two(self):
        with pytest.raises(ValueError, match="power of two"):
            tile_columns(64, 100)


class TestFolded:
    def test_same_values_and_no_constant_only_operations(self):
        c = jnp.float32(3.0)

        def fn(x):
            k = -jnp.log(c) * 2     # constant-only: folded at trace time
            return jnp.exp(-x) * k

        x = jnp.linspace(0.0, 1.0, 8, dtype=jnp.float32)
        np.testing.assert_allclose(np.asarray(_folded(fn)(x)),
                                   np.asarray(fn(x)), rtol=1e-7)
        jaxpr = jax.make_jaxpr(_folded(fn))(x).jaxpr
        assert [e.primitive.name for e in jaxpr.eqns] == ["neg", "exp", "mul"]


@pytest.mark.gpu
class TestOnTheGpu:
    @pytest.fixture(autouse=True)
    def _gpu(self):
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs a GPU")

    def test_kernels_match_xla(self):
        state = _state(256, 128)
        _assert_close(
            step_column_1m_triton(state, MP, TPS, TV, 1.0, 100.0),
            jax.jit(lambda s: step_column_1m(s, MP, TPS, TV, 1.0, 100.0))(
                state), rtol=2e-5, atol=2e-9)
        s2 = _state_2m(256, 128)
        _assert_close(
            step_column_2m(s2, MP2, TPS, 1.0, 100.0, impl="pallas"),
            step_column_2m(s2, MP2, TPS, 1.0, 100.0), rtol=2e-5, atol=1e-8)
