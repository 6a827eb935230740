"""``chip_smoke.py``: its phases at small sizes on the CPU, its refusal to
run without a GPU, and the whole script on a GPU.

The phases keep their criteria at these sizes: the reference comparisons
are Poisson/chi-square based, and the golden images were made at 1e6 rays.
"""

import jax
import pytest

import chip_smoke


def test_phase_reference():
    assert "full history" in chip_smoke.phase_reference(100_000, 10)


def test_phase_flagship():
    summary = chip_smoke.phase_flagship(intensity=1 << 13, num_iter=2)
    assert "matmul == scatter" in summary


@pytest.mark.parametrize("family", sorted(chip_smoke.FAMILIES))
def test_phase_families(family):
    summary = chip_smoke.phase_families(100_000, 5, names=(family,))
    assert summary.count("efficiency") == 1


def test_phase_plasma():
    assert "1000 bundles" in chip_smoke.phase_plasma(1 << 14, 2, 1000)


def test_phase_gradients():
    assert "align step" in chip_smoke.phase_gradients(1 << 14, n_keys=3)


def test_phase_float64():
    assert "f64" in chip_smoke.phase_float64(1 << 14)


def test_phase_four_cards():
    summary = chip_smoke.phase_four_cards(
        intensity=1 << 14, num_iter=2, grad_intensity=1 << 13, n_keys=6)
    assert "one shard per card (4 devices)" in summary


def test_compile_clock_sums_compile_events():
    clock = chip_smoke.CompileClock()
    clock("/jax/core/compile/backend_compile_duration", 1.5)
    clock("/jax/core/compile/jaxpr_trace_duration", 0.25)
    clock("/jax/other", 7.0)
    assert clock.seconds == 1.75


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as err:
        chip_smoke.main([])
    assert err.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run with JAX_PLATFORMS=cuda")
    return jax.devices()[0]


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu, capsys):
    chip_smoke.main([])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith('{"ok": true, "device": {"platform": "gpu"')
