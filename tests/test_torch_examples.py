"""The port's counterparts of ``examples/sweet_spot.py`` and
``examples/quickstart.py`` against the reference examples, on the CPU.

``examples/torch_sweet_spot.py`` (the paper's simulator and router over
``repro_torch.core``, no model) must print what the reference prints,
offline and ``--online``.  ``examples/torch_quickstart.py --device cpu``
on the reference's weights (``PRNGKey(0)``, bridged into the port) must
print the reference's per-round bills, prefix-cache stats and total; on
these random weights the smallest top-1/top-2 logit gap the port's engine
samples from is 5.4e-3, far above the two frameworks' float32 differences,
so the greedy streams, and with them the re-encoded prompts, agree.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro_torch.bridge import params_from_jax

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(scope="module")
def examples():
    """The four example modules, loaded from ``examples/`` (the reference
    sweet-spot example puts the repo root on ``sys.path`` to import its
    benchmark helper: restored afterwards)."""
    path = list(sys.path)
    mods = {}
    for name in ("sweet_spot", "torch_sweet_spot", "quickstart",
                 "torch_quickstart"):
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", EXAMPLES / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    yield mods
    sys.path[:] = path


@pytest.mark.parametrize("args", [
    ["--domain", "math500", "--max-latency", "15", "--max-cost", "0.01"],
    ["--domain", "flores"],
    ["--domain", "flores", "--online", "--n", "40"]],
    ids=["math500-ceilings", "flores", "flores-online"])
def test_sweet_spot_prints_what_the_reference_prints(examples, args,
                                                     monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["sweet_spot.py"] + args)
    examples["sweet_spot"].main()
    want = capsys.readouterr().out
    examples["torch_sweet_spot"].main(args)
    got = capsys.readouterr().out
    assert want.count("\n") > 5
    assert got == want


def test_quickstart_bills_as_the_reference(examples, capsys):
    """Same weights, same lines: three rounds' fresh input, cache reads,
    output and dollars, the prefix cache's hits and saved tokens, and the
    total; the last line names each package's own training example."""
    examples["quickstart"].main()
    want = capsys.readouterr().out.splitlines()
    jm = jbuild(jsmoke("qwen3_0_6b").replace(dtype="float32"))
    params = jm.init(jax.random.PRNGKey(0))
    port = examples["torch_quickstart"]
    m = port.build()
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    run = port.main(["--device", "cpu"], model=m)
    got = capsys.readouterr().out.splitlines()
    assert got[:-1] == want[:-1]
    assert got[-1] == want[-1].replace("train_100m", "torch_train_100m")
    reads = [r.usage.cache_read_tokens for r in run["requests"]]
    assert reads[0] == 0 and reads[1] > 0 and reads[2] > reads[1]
    assert run["prefix_cache"]["hits"] == 2


def test_quickstart_needs_a_card_by_default(examples):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        examples["torch_quickstart"].main([])
