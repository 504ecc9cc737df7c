"""chip_smoke.py and the perf helpers it shares with the benchmarks.

The phases run here at toy sizes on the CPU: that checks the state
builders, the float64 reference comparison and the four-device mesh
path. Their timings mean nothing here; the GPU run is ``python
chip_smoke.py``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402
from cloudmicrophysics_tpu import perf  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
import roofline  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
    return jax.devices()[0]


class TestDevice:
    def test_check_device_refuses_cpu(self):
        with pytest.raises(SystemExit, match="needs a GPU"):
            C.check_device()

    def test_gpu_label_refuses_cpu(self):
        with pytest.raises(RuntimeError, match="timings need a GPU"):
            perf.gpu_label()

    @pytest.mark.gpu
    def test_check_device_on_gpu(self, gpu):
        label = C.check_device()
        assert label["platform"] == "gpu" and label["kind"] == gpu.device_kind
        assert "W" in label["nvidia_smi"]


class TestCompare:
    def test_max_rel_err_is_relative_to_field_scale(self):
        want = np.array([1.0, 2.0, 4.0])
        assert C.max_rel_err(want + [0.0, 0.0, 4e-3], want) == \
            pytest.approx(1e-3)
        assert C.max_rel_err(np.zeros(2), np.zeros(2)) == 0.0

    def test_non_finite_output_is_infinitely_wrong(self):
        assert C.max_rel_err([1.0, np.nan], [1.0, 1.0]) == float("inf")

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError, match="shape"):
            C.max_rel_err(np.ones(3), np.ones(4))

    def test_catches_a_perturbed_field(self):
        want = {"a": np.linspace(1.0, 2.0, 64), "b": np.ones(64)}
        got = {k: v.copy() for k, v in want.items()}
        got["b"][17] *= 1 + 1e-3
        with pytest.raises(AssertionError, match="'b'"):
            C.compare(got, want, 1e-5)
        got["b"][17] = want["b"][17]
        errs = C.compare(got, want, 1e-5)
        assert errs["a"]["gpu_f32"] == 0.0

    def test_float32_error_on_the_cpu_sets_the_floor(self):
        want = {"a": np.ones(8)}
        base = {"a": np.ones(8) * (1 + 3e-4)}
        got = {"a": np.ones(8) * (1 + 3.05e-4)}
        errs = C.compare(got, want, 1e-5, base)
        assert errs["a"]["cpu_f32"] == pytest.approx(3e-4)
        with pytest.raises(AssertionError):
            C.compare({"a": np.ones(8) * (1 + 4e-4)}, want, 1e-5, base)


    def test_solve_flips_count_apart(self, monkeypatch):
        # a shape solve that lands elsewhere than the CPU's float32 solve
        # masks its cell and the two below, and is counted on its own
        fn = lambda x: {"ll": x * 2.0, "q": x + 1.0}
        x = jnp.linspace(1.0, 2.0, 40).reshape(4, 10)
        got = {k: np.array(v) for k, v in fn(x).items()}
        got["ll"][1, 5] *= 1.01
        got["q"][1, 4] *= 1.01     # the level below: masked with it
        errs, shares, _ = C.check(fn, (x,), got, 1e-5, solves=("ll",))
        assert shares == {"flip": 0.0, "solve_flip": 1 / 40}
        monkeypatch.setattr(C, "SOLVE_FLIP_SHARE", 0.0)
        with pytest.raises(AssertionError, match="solve_flip"):
            C.check(fn, (x,), got, 1e-5, solves=("ll",))


class TestStates:
    def test_p3_state_is_seeded_and_varies_per_cell(self):
        a = C.state_p3((4, 8), 3)
        b = C.state_p3((4, 8), 3)
        c = C.state_p3((4, 8), 4)
        for k in a._fields:
            x = np.asarray(getattr(a, k))
            assert x.dtype == np.float32, k
            np.testing.assert_array_equal(x, np.asarray(getattr(b, k)))
        assert not np.array_equal(np.asarray(a.n_ice), np.asarray(c.n_ice))
        assert np.unique(np.asarray(a.n_ice)).size == 32
        assert np.all(np.asarray(a.q_rim) <= np.asarray(a.q_ice))
        assert np.all(np.asarray(a.q_tot) > np.asarray(a.q_ice))

    def test_2m_state_holds_its_condensate(self):
        s = C.state_2m(4, 8, 0)
        assert np.all(np.asarray(s.q_tot)
                      > np.asarray(s.q_lcl) + np.asarray(s.q_rai) - 1e-9)
        assert np.asarray(s.rho)[0, 0] > np.asarray(s.rho)[0, -1]

    def test_graft_build_is_seeded(self):
        import __graft_entry__ as GE

        _, a = GE._build(4, 8, jnp.float32, seed=1)
        _, b = GE._build(4, 8, jnp.float32, seed=1)
        _, c = GE._build(4, 8, jnp.float32, seed=2)
        np.testing.assert_array_equal(np.asarray(a.q_rai), np.asarray(b.q_rai))
        assert not np.array_equal(np.asarray(a.q_rai), np.asarray(c.q_rai))

    def test_parcel_ic_is_seeded(self):
        assert float(C.parcel_ic(0).T) == float(C.parcel_ic(0).T)
        assert float(C.parcel_ic(0).T) != float(C.parcel_ic(1).T)


class TestPhasesAgainstFloat64:
    # toy sizes on the CPU: the same comparison chip_smoke makes on the GPU
    def test_1m_step(self):
        from cloudmicrophysics_tpu.models.column import ColumnState

        line = C.phase_1m(C.TINY, 0, n=1)
        assert line["cells"] == C.TINY.ncol * C.TINY.nlev
        assert set(line["max_rel_err"]) == set(ColumnState._fields)

    def test_2m_step(self):
        line = C.phase_2m(C.TINY, 0, n=1)
        assert set(line["max_rel_err"]) == set(C.ColumnState2M._fields)

    def test_p3_step_flat_and_chunked(self):
        flat, chunked = C.phase_p3(C.TINY, 0, n=1)
        assert chunked["col_chunks"] > 1
        assert "loglambda_2" in flat["max_rel_err"]
        assert 0.0 <= flat["solve_vs_f64_share"] <= 1.0
        assert flat["shares"]["solve_flip"] <= C.SOLVE_FLIP_SHARE

    def test_p3_tendency(self):
        line = C.phase_tendency(C.TINY, 0, n=1)
        assert line["chunks"] == C.TINY.cells // C.TINY.chunk_cells

    def test_parcel(self):
        line = C.phase_parcel(C.TINY, 0, n=1)
        assert line["cells"] == C.TINY.parcel_steps

    def test_four_device_mesh(self, capsys):
        C.phase_four(C.TINY, 0, n=1)
        out = capsys.readouterr().out
        assert "four_1m_step" in out and "four_p3_step_chunked" in out

    @pytest.mark.gpu
    def test_1m_step_on_gpu(self, gpu):
        line = C.phase_1m(C.TINY, 0, n=2)
        assert line["peak_bytes_in_use"] > 0


class TestPerfHelpers:
    def test_time_steps(self):
        fn = lambda x: jnp.sin(x) * 2
        x = jnp.linspace(0.0, 1.0, 16)
        compile_s, ms, compiled, out = perf.time_steps(fn, (x,), 3)
        assert compile_s > 0 and len(ms) == 3 and min(ms) > 0
        np.testing.assert_allclose(np.asarray(out), np.asarray(fn(x)))
        assert compiled.memory_analysis() is not None

    @pytest.mark.parametrize("env", [None, "from-env"])
    def test_compile_cache_dir(self, env, monkeypatch, tmp_path):
        before = jax.config.jax_compilation_cache_dir
        if env is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = str(tmp_path / "fixed")
        else:
            want = str(tmp_path / env)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        try:
            assert perf.enable_compile_cache(str(tmp_path / "fixed")) == want
            assert jax.config.jax_compilation_cache_dir == want
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_roofline_peaks(self):
        assert roofline.peaks("NVIDIA H100 80GB HBM3")[
            "hbm_bytes_per_s"] == 3.35e12
        with pytest.raises(KeyError, match="no published peaks"):
            roofline.peaks("NVIDIA A100-SXM4-40GB")
