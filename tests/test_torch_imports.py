"""The port stands alone: it imports neither JAX nor the ``repro`` package,
and its entry points refuse to run on a card that is not there."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_no_jax_and_no_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "repro" or m.startswith("repro."))
        assert not bad, bad
        assert len(names) >= 20, names
        for name in ("kernels.flash_attention", "kernels.decode_attention",
                     "models.attention", "models.transformer",
                     "serving.engine", "serving.step_graph"):
            assert "repro_torch." + name in names, name
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_imports_no_jax_and_no_repro():
    """chip_smoke.py drives the port alone: no import of JAX or of the
    reference package anywhere in it."""
    import ast
    tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert any(n.startswith("repro_torch") for n in names), names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(SRC.parent / "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_engine_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models.registry import build_model, get_smoke_config
    from repro_torch.serving.engine import Engine

    m = build_model(get_smoke_config("reflect_demo_100m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(m, ServeConfig(max_batch=1, max_seq=64, page_size=8),
               device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(m, ServeConfig(max_batch=1, max_seq=64, page_size=8))


def test_serve_launcher(capsys):
    """``launch/serve.py`` serves two reflection rounds on the CPU when
    asked, also with ``--aot`` (no step outside the warmed shapes),
    refuses the card by default when there is none, and raises for the
    options the port lacks."""
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "2", "--rounds", "2",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "2 requests x 2 rounds" in out and "on cpu" in out
    assert "'hits': 2" in out                   # round 2 hit both prefixes
    serve.main(["--device", "cpu", "--requests", "2", "--rounds", "1",
                "--max-new", "4", "--aot"])
    out = capsys.readouterr().out
    assert "aot warmup: 2 step shapes" in out and "step_compiles 0" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--requests", "1", "--rounds", "1"])
    for flag in (["--mesh", "1x1"], ["--replicas", "2"]):
        with pytest.raises(NotImplementedError):
            serve.main(["--device", "cpu", "--requests", "1", *flag])
