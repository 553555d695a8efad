"""The port stands alone: it imports neither JAX nor the ``repro`` package,
and its entry points refuse to run on a card that is not there."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the launcher and example tests serve long runs
    of small tensor operations on the CPU, which wait on every thread of
    the pool; under the suite's parallel workers a full pool made one of
    them 55x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_no_jax_and_no_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        from repro_torch.kernels import tuning   # and its committed table
        assert set(tuning.load_table()) <= set(tuning.DEFAULTS)
        bad = sorted(m for m in sys.modules
                     if m == "repro" or m.startswith("repro."))
        assert not bad, bad
        assert len(names) >= 20, names
        for name in ("kernels.flash_attention", "kernels.decode_attention",
                     "models.attention", "models.moe", "models.transformer",
                     "serving.engine", "serving.step_graph",
                     "serving.faults", "serving.trace", "serving.fleet",
                     "core", "core.accounting", "core.budget",
                     "core.controller", "core.feedback",
                     "core.parallel_sampling", "core.pareto",
                     "core.quality_sim", "core.reflection", "core.stats",
                     "core.textmetrics", "data", "data.tasks",
                     "data.tokenizer", "configs.granite_moe_1b_a400m",
                     "configs.mixtral_8x7b", "configs.kimi_k2_1t_a32b",
                     "configs.llama3_70b", "configs.minitron_4b",
                     "configs.yi_6b", "configs.nemotron_4_340b",
                     "kernels.flash_attention", "train", "train.optimizer",
                     "train.loop", "train.checkpoint", "train.quick_fit",
                     "data.lm_data", "launch.train", "bridge",
                     "models.whisper", "models.vlm", "configs.whisper_tiny",
                     "configs.internvl2_76b", "launch.mesh", "launch.rules",
                     "launch.sharding", "launch.dryrun", "launch.stepcost",
                     "launch.serve", "kernels.tuning"):
            assert "repro_torch." + name in names, name
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imported(script):
    """Every module name that ``script`` imports, anywhere in it."""
    import ast
    tree = ast.parse((SRC.parent / script).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    return names


def test_chip_smoke_imports_no_jax_and_no_repro():
    """chip_smoke.py drives the port alone: no import of JAX or of the
    reference package anywhere in it."""
    names = _imported("chip_smoke.py")
    assert any(n.startswith("repro_torch") for n in names), names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_reflection_example_imports_no_jax_and_no_repro():
    names = _imported("examples/torch_reflection_serving.py")
    assert any(n.startswith("repro_torch") for n in names), names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_train_example_imports_no_jax_and_no_repro():
    names = _imported("examples/torch_train_100m.py")
    assert any(n.startswith("repro_torch") for n in names), names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


@pytest.mark.parametrize("script", ["examples/torch_quickstart.py",
                                    "examples/torch_sweet_spot.py"])
def test_new_examples_import_no_jax_repro_or_benchmarks(script):
    """The quickstart and sweet-spot counterparts import only the port
    (the sweet-spot one keeps its own copy of the benchmarks' grid)."""
    names = _imported(script)
    assert any(n.startswith("repro_torch") for n in names), names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro",
                                                    "benchmarks")]
    assert not bad, bad


def test_kernel_wrappers_without_backward_refuse_gradients():
    """A CUDA wrapper whose kernel has no backward (paged decode, paged
    extend, ring decode) raises when grad mode is on and an input requires
    a gradient, before anything else is checked (meta tensors stand in for
    CUDA ones: they take the kernel branch), and names the ROADMAP item;
    under ``torch.no_grad()`` the same call goes on to the operand
    checks."""
    from repro_torch.kernels import ops
    m = lambda *s: torch.empty(s, device="meta")
    q4, pool, pt, pos = m(2, 2, 3, 64), m(8, 16, 2, 64), m(2, 4), m(2)
    calls = {
        "paged_decode": lambda g: ops.paged_decode_attention(
            q4.requires_grad_(g), pool, pool, pt, pos),
        "paged_extend": lambda g: ops.paged_extend_attention(
            m(2, 5, 2, 3, 64).requires_grad_(g), pool, pool, pt, pos),
        "decode_attention": lambda g: ops.decode_attention(
            q4.requires_grad_(g), m(2, 32, 2, 64), m(2, 32, 2, 64),
            m(2, 32), pos),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward "
                           "kernel on the card \\(ROADMAP A16d\\)"):
            call(True)
        with torch.no_grad(), pytest.raises(ValueError):
            call(True)


def test_scan_wrappers_under_grad_reach_their_autograd_functions(
        monkeypatch):
    """The two scans have backward kernels: under grad mode a CUDA-side
    call (meta tensors stand in for CUDA ones) goes through the wrapper's
    autograd function, whose forward reaches the kernel launch's operand
    checks (ValueError: meta tensors are not CUDA tensors); under
    ``torch.no_grad()`` the same call reaches those checks without the
    function."""
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as RS
    m = lambda *s: torch.empty(s, device="meta")
    reached = []
    for mod, fn in ((MS, "_MambaScan"), (RS, "_RGLRUScan")):
        real = getattr(mod, fn)

        class Spy:
            @staticmethod
            def apply(*a, real=real, fn=fn):
                reached.append(fn)
                return real.apply(*a)

        monkeypatch.setattr(mod, fn, Spy)
    calls = {
        "_MambaScan": lambda g: ops.mamba_scan(
            m(2, 4, 8).requires_grad_(g), m(2, 4, 16), m(2, 4, 16),
            m(2, 4, 8), m(8, 16), m(8), m(2, 8, 16)),
        "_RGLRUScan": lambda g: ops.rglru_scan(
            m(2, 4, 8).requires_grad_(g), m(2, 4, 8), m(2, 8)),
    }
    for fn, call in calls.items():
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            call(True)
        assert reached == [fn]
        with torch.no_grad(), pytest.raises(ValueError,
                                            match="takes CUDA tensors"):
            call(True)
        assert reached == [fn]
        reached.clear()


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
    refuses the card by default when there is none, serves on a 1x1 mesh
    (``--mesh 1x1``: the reference's mesh line, per-device KV equal to the
    whole), and serves a fleet with ``--replicas``."""
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
    serve.main(["--device", "cpu", "--requests", "2", "--rounds", "2",
                "--max-new", "4", "--mesh", "1x1"])
    out = capsys.readouterr().out
    assert "2 requests x 2 rounds" in out and "'hits': 2" in out
    line = next(x for x in out.splitlines() if x.startswith("mesh "))
    assert line.startswith("mesh {'data': 1, 'model': 1} (1 dev, "), line
    total = line.split("resident KV ")[1].split(" B total")[0]
    assert f"{total} B/device" in line
    serve.main(["--device", "cpu", "--replicas", "2", "--trace-requests",
                "6", "--max-new", "5"])
    out = capsys.readouterr().out
    assert "fleet: 2 replicas, policy=affinity, 6 requests" in out
    assert "leaked pages after cache release: 0" in out


REGISTRY_ARCHS = ("granite_moe_1b_a400m", "qwen3_0_6b", "recurrentgemma_9b",
                  "nemotron_4_340b", "minitron_4b", "kimi_k2_1t_a32b",
                  "yi_6b", "internvl2_76b", "falcon_mamba_7b", "whisper_tiny",
                  "reflect_demo_100m", "mixtral_8x7b", "llama3_70b")


def test_registry_serves_all_but_whisper_and_vlm():
    """The port's registry has all 13 of the reference's architectures,
    whisper and the VLM included (the name is the one this test had
    while those two were still to port), under the reference's ids and
    aliases, with the reference's configs, and builds each family's model
    class."""
    from repro.models import registry as J
    from repro_torch.models import registry as R
    assert R.ARCH_IDS == J.ARCH_IDS
    assert R.EXTRA_ARCH_IDS == J.EXTRA_ARCH_IDS
    assert set(R.ARCH_IDS + R.EXTRA_ARCH_IDS) == set(REGISTRY_ARCHS)
    assert R.ALIASES == J.ALIASES
    for alias, arch in J.ALIASES.items():
        assert R.get_config(alias) == R.get_config(arch)
    for arch in REGISTRY_ARCHS:
        for get in ("get_config", "get_smoke_config"):
            want = dataclasses.asdict(getattr(J, get)(arch))
            assert dataclasses.asdict(getattr(R, get)(arch)) == want, arch
    kinds = {arch: type(R.build_model(R.get_smoke_config(arch))).__name__
             for arch in ("whisper-tiny", "internvl2_76b", "yi_6b")}
    assert kinds == {"whisper-tiny": "WhisperModel",
                     "internvl2_76b": "VLMModel", "yi_6b": "TransformerLM"}
    with pytest.raises(ValueError, match="unknown architecture"):
        R.get_smoke_config("whisper_large")


@pytest.mark.parametrize("arch", REGISTRY_ARCHS)
def test_serve_launcher_serves_every_registry_arch(arch, capsys):
    """``--arch`` takes every id of the registry: two rounds of the smoke
    config with warmed steps on the CPU, round 2 hitting the prefix
    cache, no step outside the warmed shapes."""
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                "--rounds", "2", "--max-new", "4", "--aot"])
    out = capsys.readouterr().out
    assert "2 requests x 2 rounds" in out and "step_compiles 0" in out
    assert "'hits': 2" in out


def _reflection_example():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_reflection_serving",
        SRC.parent / "examples" / "torch_reflection_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reflection_example(capsys):
    """``examples/torch_reflection_serving.py --device cpu`` serves the
    strategy grid on the smoke config: a bill per strategy, every
    reflection round reading the conversation from the cache, the paper's
    modeled latency beside the wall on the CPU, per round index."""
    _reflection_example().main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "serving on cpu" in out
    rows = [ln.split() for ln in out.splitlines()
            if ln.startswith(("reflect", "routed")) and "fresh_in" in ln]
    assert [r[0] for r in rows] == ["reflect0/none", "reflect1/none",
                                    "reflect1/exec", "reflect3/none",
                                    "reflect3/exec"]
    fresh = [int(r[2]) for r in rows]
    cached = [int(r[4]) for r in rows]
    outs = [int(r[6]) for r in rows]
    assert outs == [96, 192, 192, 384, 384]     # 4 tasks x 24 x rounds
    assert cached[3] > fresh[3] and cached[4] > fresh[4]
    assert all(float(r[7].lstrip("$")) > 0 for r in rows)
    rounds = [ln for ln in out.splitlines() if "round 3: modeled" in ln]
    assert len(rounds) == 2 and all("(cpu)" in ln for ln in rounds)
    later = [float(ln.split("cache-read share ")[1].split(";")[0])
             for ln in out.splitlines()
             if "modeled median" in ln and "round 0:" not in ln]
    assert len(later) == 2 + 2 * 3 and min(later) > 0
    assert "random weights: noise" in out


def test_reflection_example_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _reflection_example().main([])
