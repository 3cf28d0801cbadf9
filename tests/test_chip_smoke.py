"""chip_smoke.py's phases at a tiny size on the CPU, its refusal to run
without a GPU or without the rest of the repository, and the GPU-only
precision check it makes on the card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_phase_models_tiny():
    errors = chip_smoke.phase_models(
        models=("gin", "gin-vn", "dgn"), stream_graphs=24, node_cap=512,
        graph_cap=32, compare=8,
    )
    for name, errs in errors.items():
        assert set(errs) == {"bf16", "f32_highest", "f32_default_dots"}
        assert errs["f32_highest"] <= chip_smoke.F32_TOL
        assert errs["bf16"] <= chip_smoke.BF16_TOL[name]


def test_phase_models_flags_a_wrong_model(monkeypatch):
    """A model that disagrees with its oracle fails the phase."""
    from flowgnn_tpu.models import registry

    spec = registry.get("gcn")
    wrong = spec.__class__(**{**spec.__dict__,
                              "forward": lambda p, b, prec: spec.forward(
                                  p, b, prec) * 1.01})
    monkeypatch.setitem(registry.MODELS, "gcn", wrong)
    with pytest.raises(AssertionError, match="gcn"):
        chip_smoke.phase_models(models=("gcn",), stream_graphs=24,
                                node_cap=512, graph_cap=32, compare=8)


def test_phase_serve_tiny():
    assert chip_smoke.phase_serve(num_graphs=24, flip=5, caps=(256, 16)) == 24


def test_phase_bench_tiny(capsys):
    results = chip_smoke.phase_bench(16, 1, model="pna", cpu_rehearsal=True)
    assert results["pna"]["us_per_graph"] > 0
    assert "[bench] pna:" in capsys.readouterr().out


def test_phase_multi_tiny():
    errors = chip_smoke.phase_multi(
        models=("gin", "pna"), num_graphs=24, node_cap=255, graph_cap=8,
    )
    assert ("gin", "psum 2x2") in errors
    assert {label for _, label in errors} == {"halo 2x2", "halo 1x4", "psum 2x2"}
    assert max(errors.values()) <= chip_smoke.F32_TOL


def test_oracle_error_is_allclose_tolerance():
    a, b = np.array([1.0, 2.0]), np.array([1.0, 2.1])
    t = chip_smoke.oracle_error(a, b)
    assert np.allclose(a, b, rtol=t * 1.0001, atol=t * 1.0001)
    assert not np.allclose(a, b, rtol=t * 0.99, atol=t * 0.99)


def test_main_refuses_the_cpu(capsys):
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """Without the rest of the repository the script fails and prints no
    result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "flowgnn_tpu" in proc.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("name", chip_smoke.MODELS)
def test_f32_on_gpu_is_not_tf32(name, gpu):
    """On the card, FLOAT32 (dots at HIGHEST) stays within 1e-4 of the f64
    oracle; TF32 would not be held to it."""
    errors = chip_smoke.phase_models(models=(name,), stream_graphs=200,
                                     node_cap=4096, graph_cap=256, compare=64)
    assert errors[name]["f32_highest"] <= chip_smoke.F32_TOL
    json.dumps(errors)
