"""The port's mesh and launch tooling (``repro_torch/launch/``) against the
JAX package's: ``spec_for`` on the reference's rule cases and on random
shapes, axes and meshes; the logical axes of every parameter and cache
leaf of all 13 archs at full width (built on ``meta``); the dry run's
parameter counts and per-device parameter bytes; ``SHAPES``; and the
meta-device dry run itself."""
import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import SHAPES as JSHAPES
from repro.launch import rules as JR
from repro.models import layers as JL
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_config as jconfig
from repro_torch.bridge import is_stacked, reference_groups
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun, rules as R, sharding as SH
from repro_torch.launch.mesh import (MeshShape, make_production_mesh,
                                     parse_mesh_spec)
from repro_torch.models.registry import (ARCH_IDS, EXTRA_ARCH_IDS,
                                         build_model, get_config)

ALL_ARCHS = ARCH_IDS + EXTRA_ARCH_IDS


class FakeMesh:
    """The reference tests' stand-in: axis names and a device grid."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.zeros(shape)


MESH = FakeMesh(("data", "model"), (16, 16))          # make_production_mesh
MESH3 = FakeMesh(("pod", "data", "model"), (2, 16, 16))
HOST2 = FakeMesh(("data", "model"), (1, 2))           # make_serve_mesh("1x2")

# every case of tests/test_sharding_rules.py's rule tests:
# (shape, axes, mesh, rules, the reference's expected spec)
RULE_CASES = [
    ((4096, 11008), ("embed", "ff"), MESH, None, ("data", "model")),
    ((256, 4096), ("batch", None), MESH3, None, (("pod", "data"),)),
    ((3072, 24, 128), ("embed", "heads", None), MESH, None, ("data",)),
    ((1, 524288, 8, 128), ("batch", "kv_seq", "kv_heads", None), MESH3,
     None, (None, ("model", "pod", "data"))),
    ((32, 1024, 512), ("experts", "embed", "ff"), MESH, None,
     ("model", "data")),
    ((128, 32768, 8, 128), ("batch", "kv_seq", "kv_heads", None), MESH,
     None, ("data", "model")),
    ((256, 16, 8, 128), ("pages", None, "kv_heads", None), MESH, "serve",
     ("model",)),
    ((256, 16, 8), ("pages", None, "kv_heads"), MESH, "serve", ("model",)),
    ((28, 256, 16, 8, 128), ("layers", "pages", None, "kv_heads", None),
     MESH, "serve", (None, "model")),
    ((4096, 11008), ("embed", "ff"), MESH, "serve", (None, "model")),
    ((128, 16, 2, 64), ("pages", None, "kv_heads", None), HOST2, "serve",
     ("model",)),
    ((128, 16, 2), ("pages", None, "kv_heads"), HOST2, "serve", ("model",)),
    ((127, 16, 2, 64), ("pages", None, "kv_heads", None), HOST2, "serve",
     (None, None, "model")),
]


@pytest.mark.parametrize("shape,axes,mesh,rules,want", RULE_CASES)
def test_spec_for_matches_reference_cases(shape, axes, mesh, rules, want):
    got = R.spec_for(shape, axes, mesh,
                     R.serve_rules() if rules == "serve" else None)
    ref = JR.spec_for(shape, axes, mesh,
                      JR.serve_rules() if rules == "serve" else None)
    assert got == want == tuple(ref)


def test_paged_pool_defs_resolve_sharded():
    """The port's real pool defs (int8: payload and three sidecars) lead
    with ``pages`` and resolve to page-sharded placement, as the
    reference's."""
    from repro_torch.models.attention import paged_kv_cache_def
    from repro_torch.models.registry import get_smoke_config
    d = paged_kv_cache_def(get_smoke_config("qwen3_0_6b"), 256, 16,
                           torch.float32, "int8")
    assert set(d) == {"kp", "vp", "ksp", "kzp", "vsp"}
    for name, leaf in d.items():
        assert R.spec_for(leaf.shape, leaf.axes, MESH,
                          R.serve_rules()) == ("model",), name


RULE_SETS = {"default": (None, None), "tp": (R.tp_rules(), JR.tp_rules()),
             "serve": (R.serve_rules(), JR.serve_rules()),
             "decode": (R.decode_rules(), JR.decode_rules())}
LOGICAL = [None, "nope", *sorted(R.DEFAULT_RULES)]


@st.composite
def _case(draw):
    names = draw(st.sampled_from([("model",), ("data", "model"),
                                  ("pod", "data", "model")]))
    sizes = tuple(draw(st.sampled_from([1, 2, 3, 4, 16])) for _ in names)
    ndim = draw(st.integers(0, 5))
    shape = tuple(draw(st.sampled_from([1, 2, 3, 6, 8, 24, 48, 64, 127,
                                        256])) for _ in range(ndim))
    axes = tuple(draw(st.sampled_from(LOGICAL)) for _ in range(ndim))
    return FakeMesh(names, sizes), shape, axes, draw(st.sampled_from(
        sorted(RULE_SETS)))


@settings(max_examples=300, deadline=None)
@given(_case())
def test_spec_for_property_matches_reference(case):
    mesh, shape, axes, rules = case
    mine, ref = RULE_SETS[rules]
    assert R.spec_for(shape, axes, mesh, mine) == tuple(
        JR.spec_for(shape, axes, mesh, ref))


def test_placements():
    """A spec as DTensor placements: Shard(dim) on the mesh dims it names,
    Replicate elsewhere and on every mesh dim of size 1."""
    from torch.distributed.tensor import Replicate, Shard
    m = MeshShape(("data", "model"), (4, 2))
    assert R.placements(("data", None, "model"), m) == [Shard(0), Shard(2)]
    assert R.placements((None, "model"), m) == [Replicate(), Shard(1)]
    assert R.placements(((("data", "model")),), m) == [Shard(0), Shard(0)]
    assert R.placements(("model",), MeshShape(("data", "model"), (1, 1))) \
        == [Replicate(), Replicate()]
    assert R.shard_bytes((8, 6), torch.float32, ("data", "model"), m) \
        == 2 * 3 * 4
    assert SH.batch_sharding(m, 3) == [Shard(0), Replicate()]
    assert SH.batch_sharding_for(m, (6, 5)) == [Replicate(), Replicate()]
    assert SH.batch_sharding_for(m, (8, 5)) == [Shard(0), Replicate()]
    assert SH.replicated(m) == [Replicate(), Replicate()]


def test_mesh_spec_errors():
    assert parse_mesh_spec(" 1X2 ") == (1, 2)
    with pytest.raises(ValueError, match="not of the form"):
        parse_mesh_spec("2")
    with pytest.raises(ValueError, match="non-positive"):
        parse_mesh_spec("0x2")
    assert make_production_mesh().size() == 256
    assert make_production_mesh(multi_pod=True).axis_names == (
        "pod", "data", "model")


# ---------------------------------------------------------------- axes

def _ref_flat(tree):
    """{path: ParamDef} of a reference defs tree, paths as in
    ``bridge.reference_groups``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=JL.is_def)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            d for path, d in flat}


def _check_axes(ref_flat, port_defs, cfg):
    groups = reference_groups(list(port_defs), cfg)
    assert set(groups) == set(ref_flat)
    for path, names in groups.items():
        ref = ref_flat[path]
        for n in names:
            lead = (("layers",), (len(names),)) if is_stacked(names) \
                else ((), ())
            got = port_defs[n]
            assert lead[0] + tuple(got.axes) == tuple(ref.axes), (path, n)
            assert lead[1] + tuple(got.shape) == tuple(ref.shape), (path, n)


@pytest.fixture(scope="module")
def meta_models():
    out = {}
    for arch in ALL_ARCHS:
        with torch.device("meta"):
            out[arch] = build_model(get_config(arch))
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_axes_match_reference(meta_models, arch):
    """Every parameter's and cache leaf's logical axes (and shape) are the
    reference's ``param_defs`` / ``cache_defs`` / ``cache_defs_paged``
    ones, a stacked reference leaf carrying ``layers`` in front."""
    cfg, m = get_config(arch), meta_models[arch]
    jm = jbuild(jconfig(arch))
    _check_axes(_ref_flat(jm.param_defs()), dict(m.named_parameters()), cfg)
    B, S = 2, 64
    for seq_shard in (True, False):
        port = m.cache_defs(B, S, "int8", seq_shard=seq_shard)
        ref = _ref_flat(jm.cache_defs(B, S, seq_shard=seq_shard,
                                      kv_dtype="int8"))
        if cfg.arch_type == "audio":
            for name in port[0]:
                part = "cross" if name in ("xk", "xv") else "self"
                for layer in port:
                    d, r = layer[name], ref[(part, name)]
                    assert ("layers",) + d.axes == r.axes, name
                    assert (len(port),) + d.shape == r.shape, name
            continue
        _check_axes(ref, {f"blocks.{i}.{k}": d for i, layer in
                          enumerate(port) for k, d in layer.items()}, cfg)
    if hasattr(m, "cache_defs_paged"):
        port = m.cache_defs_paged(96, 16, "int8", B)
        ref = _ref_flat(jm.cache_defs_paged(B, 96, 16, kv_dtype="int8"))
        _check_axes(ref, {f"blocks.{i}.{k}": d for i, layer in
                          enumerate(port) for k, d in layer.items()}, cfg)


@contextlib.contextmanager
def _reference_dryrun():
    """The reference's ``launch/dryrun.py``, imported with jax already up
    (its first lines set a 512-device XLA flag, which then changes
    nothing) and the environment restored."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
        yield jdry
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_stats_and_device_bytes_match_reference(meta_models, arch):
    """``params_total`` / ``params_active`` and one device's parameter
    bytes under ``rules_for(arch)`` on the 16x16 mesh equal the
    reference's (its ``param_stats``; its ``spec_for`` shard shapes)."""
    cfg, m = get_config(arch), meta_models[arch]
    jm = jbuild(jconfig(arch))
    with _reference_dryrun() as jdry:
        assert dryrun.param_stats(cfg, m) == jdry.param_stats(
            jconfig(arch), jm.param_defs())
        jrules = jdry.rules_for(arch)
    want = 0
    for d in JL.tree_defs(jm.param_defs()):
        spec = JR.spec_for(d.shape, d.axes, MESH, jrules)
        n = 1
        for dim, entry in zip(d.shape, tuple(spec) + (None,) * 8):
            div = 1
            for name in ((entry,) if isinstance(entry, str) else entry or ()):
                div *= 16
            n *= dim // div
        want += n * np.dtype(d.dtype).itemsize
    assert dryrun.device_bytes(m, make_production_mesh(),
                               dryrun.rules_for(arch)) == want


def test_shapes_match_reference():
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.kind)
        for k, v in JSHAPES.items()}
    assert SHAPES["long_500k"].is_decode and not SHAPES["train_4k"].is_decode


def test_dryrun_whisper_decode():
    """The two whisper_tiny x decode_32k combos (16x16, 2x16x16) run on
    ``meta`` and end with the reference's line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun.main(["--arch", "whisper_tiny", "--shape", "decode_32k",
                     "--mesh", "both"])
    text = out.getvalue()
    assert text.rstrip().endswith("all dry-runs passed"), text
    assert text.count("OK   whisper_tiny x decode_32k") == 2
    assert "not counted" in text


def test_opt_state_shardings():
    """AdamW's m / v mirror the params; Adafactor's factored slots drop a
    dim of the (stacked) reference leaf."""
    from repro_torch.models.registry import get_smoke_config
    cfg = get_smoke_config("reflect_demo_100m")
    with torch.device("meta"):
        m = build_model(cfg)
    mesh = MeshShape(("data", "model"), (1, 2))
    params = SH.sharding_for_defs(m, mesh)
    adam = SH.opt_state_shardings(m, mesh, "adamw")
    assert adam["m"] == params and adam["v"] == params
    groups = reference_groups(dict(m.named_parameters()), cfg)
    defs = SH.opt_state_defs(m, "adafactor", groups)
    for path, names in groups.items():
        p = dict(m.named_parameters())[names[0]]
        slot = defs["slots"][path]
        lead = (len(names),) if is_stacked(names) else ()
        full = lead + tuple(p.shape)
        if "vr" in slot:
            assert slot["vr"].shape == full[:-1]
            assert slot["vc"].shape == full[:-2] + full[-1:]
        else:
            assert slot["v"].shape == full
