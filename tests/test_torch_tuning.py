"""The port's tuning table (``repro_torch/kernels/tuning.py``) on the CPU.

The three split walks (paged decode, paged extend, ring decode) take
their split count from ``tuning.splits``: the committed table's entry for
the card and the shape's bucket, clamped as the heuristic is, else the
heuristic (``cuda_lib.paged_splits`` / ``ring_splits``).  Here: the
reference's fallback and resolve checks on the port's module; an empty
table gives the heuristic's count over a grid of shapes, also in the
arguments the wrappers hand their launch (meta tensors stand in for
CUDA ones); clamping; malformed tables raise when loaded; ``shape_key``
equals the reference's; the cost models equal ``chip_smoke.py``'s bound
at the same shapes; and every committed entry carries its card, power
limit and a time below the heuristic's.
"""
import importlib.util
import itertools
import json
import re
import types
from pathlib import Path

import pytest
import torch

from repro.kernels import tuning as jtuning
from repro_torch.kernels import cuda_lib, ops, tuning
from repro_torch.kernels.decode_attention import split_plan as ring_plan
from repro_torch.kernels.paged_attention import split_plan as decode_plan
from repro_torch.kernels.paged_extend import split_plan as extend_plan

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def table(monkeypatch, tmp_path):
    """Point the module at a table file under ``tmp_path``: ``write(t)``
    writes it and reads it in; with nothing written there is no file."""
    path = tmp_path / "tuning_table.json"
    monkeypatch.setattr(tuning, "TABLE_PATH", str(path))
    tuning.load_table(refresh=True)

    def write(t):
        path.write_text(json.dumps(t))
        return tuning.load_table(refresh=True)

    yield write
    monkeypatch.undo()
    tuning.load_table(refresh=True)


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entry(n, **meta):
    return {"params": {"splits": n}, "us": 20.0, "model_us": 2.0, **meta}


def test_tuning_lookup_falls_back_to_defaults(table):
    """Unknown shapes, unknown kernels and a missing table give the
    defaults (the heuristic's count), never an error."""
    assert tuning.load_table() == {}
    params = tuning.lookup("paged_extend", "cpu", b=7, k=3, tiles=1,
                           slots=12345, hd=999)
    assert params == {"splits": None}
    assert tuning.lookup("decode", "cpu", b=1, k=1, slots=31, hd=1) == {
        "splits": None}
    assert tuning.lookup("no_such_kernel") == {}
    assert tuning.splits("paged_decode", "cpu", b=3, k=2, slots=256,
                         hd=64) == (cuda_lib.paged_splits(3, 2, 1, 256, 64),
                                    "heuristic")


def test_tuning_table_entries_resolve(monkeypatch):
    """Every committed entry names a tunable kernel and its params, the
    card and power limit it was measured on, and a median below the
    heuristic's; on that card the shape it was keyed at resolves to it."""
    table = tuning.load_table(refresh=True)
    for kernel, backends in table.items():
        allowed = set(tuning.DEFAULTS[kernel])
        for be, entries in backends.items():
            for key, entry in entries.items():
                assert set(entry["params"]) <= allowed, (kernel, key)
                assert entry["us"] > 0 and entry["model_us"] > 0
                assert entry["us"] < entry["heuristic_us"], (kernel, key)
                assert entry["power_limit_w"] > 0
                assert re.sub(r"\W", "_", entry["device"].lower()) == be
                dims = {k: int(v)
                        for k, v in re.findall(r"([a-z]+)(\d+)", key)}
                assert tuning.shape_key(**dims) == key
                monkeypatch.setattr(tuning, "backend_key",
                                    lambda device=None, be=be: be)
                tuning.load_table(refresh=True)
                most = dims["slots"] // cuda_lib.stage_slots(dims["hd"])
                assert tuning.splits(kernel, "cpu", **dims) == (
                    max(1, min(entry["params"]["splits"], most)), "table")
                monkeypatch.undo()
    tuning.load_table(refresh=True)


# B 1-16, K 1-8, hd 32-256, tables and rings of 16-4096 slots, Sx 1/5/32
GRID = list(itertools.product((1, 2, 3, 5, 8, 16), (1, 2, 4, 8),
                              (32, 64, 128, 256), (16, 100, 256, 2048, 4096)))


def test_empty_table_gives_the_heuristic(table):
    """With no table every split plan is the heuristic's count, for every
    kernel dtype code of paged extend (whose row tile it sets)."""
    for B, K, hd, slots in GRID:
        assert decode_plan("cpu", B, K, hd, slots) == (
            cuda_lib.paged_splits(B, K, 1, slots, hd), "heuristic")
        assert ring_plan("cpu", B, K, slots, hd) == (
            cuda_lib.ring_splits(B, K, slots, hd), "heuristic")
        for Sx, G, code in itertools.product((1, 5, 32), (1, 3, 16),
                                             range(4)):
            tiles = -(-Sx * G // cuda_lib.extend_rows(hd, Sx * G, code))
            assert extend_plan("cpu", B, Sx, K, G, hd, slots, code) == (
                cuda_lib.paged_splits(B, K, tiles, slots, hd), "heuristic")


@pytest.mark.parametrize("B,K,G,hd,NP,Sx", [
    (8, 4, 3, 64, 128, 5), (8, 1, 16, 256, 128, 32), (3, 2, 5, 32, 7, 1),
    (16, 8, 2, 128, 64, 32)])
def test_wrappers_launch_the_heuristic_count_without_a_table(
        table, monkeypatch, B, K, G, hd, NP, Sx):
    """With no table the three wrappers hand their launch the heuristic's
    count (meta tensors take the kernel branch; the operand checks, the
    stream and the launch are stubbed)."""
    seen = []
    monkeypatch.setattr(cuda_lib, "check_kv_inputs",
                        lambda kind, q, k, *a: cuda_lib.DTYPE_CODES[
                            (q.dtype, k.dtype)])
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda name, *args: seen.append((name, args[-2])))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    m = lambda *s, dt=torch.float32: torch.empty(s, device="meta", dtype=dt)
    ps, C = 16, NP * 16
    pool, pt, pos = m(B * NP, ps, K, hd), m(B, NP, dt=torch.int32), \
        m(B, dt=torch.int32)
    tiles = -(-Sx * G // cuda_lib.extend_rows(hd, Sx * G, 0))
    with torch.no_grad():
        ops.paged_decode_attention(m(B, K, G, hd), pool, pool, pt, pos)
        ops.paged_extend_attention(m(B, Sx, K, G, hd), pool, pool, pt, pos)
        ops.decode_attention(m(B, K, G, hd), m(B, C, K, hd), m(B, C, K, hd),
                             m(B, C, dt=torch.int32), pos)
    assert seen == [
        ("paged_decode", cuda_lib.paged_splits(B, K, 1, NP * ps, hd)),
        ("paged_extend", cuda_lib.paged_splits(B, K, tiles, NP * ps, hd)),
        ("decode_attention", cuda_lib.ring_splits(B, K, C, hd))]


def test_table_count_is_clamped_and_cached(table, monkeypatch):
    """A table count beyond the stages of the table is clamped to them;
    a count within is taken as it stands; shapes in another bucket, and
    another card's entries, keep the heuristic; the answer is the same on
    every call."""
    key = tuning.shape_key(b=8, k=4, slots=2048, hd=64)
    write = table
    write({"paged_decode": {"cpu": {key: _entry(1000)}},
           "decode": {"cpu": {key: _entry(5)},
                      "nvidia_h100_80gb_hbm3": {
                          tuning.shape_key(b=2, k=2, slots=64, hd=32):
                          _entry(3)}}})
    assert tuning.splits("paged_decode", "cpu", b=8, k=4, slots=2048,
                         hd=64) == (2048 // 64, "table")
    assert tuning.splits("paged_decode", "cpu", b=7, k=3, slots=1500,
                         hd=64) == (1500 // 64, "table")    # same bucket
    assert tuning.splits("decode", "cpu", b=8, k=4, slots=2048,
                         hd=64) == (5, "table")
    assert tuning.splits("decode", "cpu", b=2, k=2, slots=64, hd=32) == (
        cuda_lib.ring_splits(2, 2, 64, 32), "heuristic")
    assert tuning.splits("decode", "cpu", b=16, k=4, slots=2048,
                         hd=64) == (cuda_lib.ring_splits(16, 4, 2048, 64),
                                    "heuristic")
    monkeypatch.setattr(cuda_lib, "ring_splits", lambda *a: 77)
    assert tuning.splits("decode", "cpu", b=16, k=4, slots=2048,
                         hd=64)[0] != 77                     # cached


@pytest.mark.parametrize("bad,match", [
    ({"flash": {"cpu": {}}}, "unknown kernel 'flash'"),
    ({"paged_extend": {"cpu": {"k": {"params": {"bq": 64}}}}},
     r"names \['bq'\]"),
    ({"decode": {"cpu": {"k": {"params": {"splits": 0}}}}},
     "positive int"),
    ({"decode": {"cpu": {"k": {"params": {"splits": 2.5}}}}},
     "positive int")])
def test_malformed_table_raises_at_load(table, bad, match):
    with pytest.raises(ValueError, match=match):
        table(bad)


def test_record_writes_a_checked_entry(table, tmp_path):
    """``record`` writes the entry with its metadata to the table it is
    given (and refuses what the loader would)."""
    out = tmp_path / "swept.json"
    tuning.record("decode", "b8_hd64_k4_slots2048", {"splits": 6}, us=21.25,
                  model_us=4.5, heuristic_us=26.0, device="NVIDIA H100",
                  power_limit_w=700.0, backend="nvidia_h100",
                  path=str(out))
    got = json.loads(out.read_text())
    assert got == {"decode": {"nvidia_h100": {"b8_hd64_k4_slots2048": {
        "params": {"splits": 6}, "us": 21.25, "model_us": 4.5,
        "heuristic_us": 26.0, "device": "NVIDIA H100",
        "power_limit_w": 700.0}}}}
    with pytest.raises(ValueError):
        tuning.record("decode", "x", {"bk": 64}, us=1, model_us=1,
                      backend="cpu", path=str(out))


def test_shape_key_and_backend_key_match_the_reference():
    for dims in ({"ctx": 256, "hd": 64, "r": 16}, {"s": 512, "hd": 64},
                 {"b": 8, "k": 4, "tiles": 3, "slots": 2000, "hd": 256},
                 {"b": 1, "k": 1, "slots": 1, "hd": 33}):
        assert tuning.shape_key(**dims) == jtuning.shape_key(**dims)
    assert tuning.backend_key("cpu") == "cpu"


@pytest.mark.parametrize("dtype,quant", [
    (torch.bfloat16, False), (torch.float32, False), (torch.float32, True),
    (torch.bfloat16, True)])
@pytest.mark.parametrize("B,Sx,K,G,hd,ctx,NP", [
    (8, 5, 4, 3, 64, 2048, 128), (8, 32, 1, 16, 256, 2048, 128),
    (8, 1, 8, 2, 64, 1024, 128), (3, 7, 2, 4, 128, 96, 8)])
def test_paged_cost_models_equal_the_chip_bound(chip_smoke, dtype, quant, B,
                                                Sx, K, G, hd, ctx, NP):
    """On a batch whose every lane sees the same ``ctx`` slots (the
    first ctx / 16 pages of each row mapped, positions past them), the
    paged extend and decode models equal ``chip_smoke.bound_ms`` of
    ``chip_smoke.work``'s bytes and operations."""
    from repro_torch.kernels import kv_quant
    ps = 16
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, Sx, K, G, hd, generator=g).to(dtype)
    kp = torch.randn(B * NP, ps, K, hd, generator=g)
    pt = torch.arange(B * NP, dtype=torch.int32).view(B, NP)
    pt[:, ctx // ps:] = -1
    pos0 = torch.full((B,), NP * ps, dtype=torch.int32)
    sc = {}
    if quant:
        kp, ks, kz = kv_quant.quantize_k(kp)
        sc = {"k_scale": ks, "k_zero": kz}
    else:
        kp = kp.to(dtype)
    nbytes, nops = chip_smoke.work(q, kp, pt, pos0, sc, None)
    want = chip_smoke.bound_ms(nbytes, nops, dtype)[0] * 1e3
    kw = dict(B=B, K=K, G=G, hd=hd, ctx=ctx, quant=quant, NP=NP,
              dtype=dtype)
    assert tuning.extend_cost_model_us(Sx=Sx, **kw) == pytest.approx(
        want, rel=1e-12)
    nbytes, nops = chip_smoke.work(q[:, :1], kp, pt, pos0, sc, None)
    want = chip_smoke.bound_ms(nbytes, nops, dtype)[0] * 1e3
    assert tuning.paged_decode_cost_model_us(**kw) == pytest.approx(
        want, rel=1e-12)


@pytest.mark.parametrize("dtype,quant", [
    (torch.bfloat16, False), (torch.float32, False), (torch.float32, True)])
@pytest.mark.parametrize("B,K,G,hd,C,ctx", [
    (8, 4, 3, 64, 2048, 2048), (8, 1, 16, 256, 2048, 1500),
    (8, 8, 2, 64, 2048, 700), (2, 2, 16, 32, 64, 64)])
def test_ring_cost_model_equals_the_chip_bound(chip_smoke, dtype, quant, B,
                                               K, G, hd, C, ctx):
    """On rings whose every row holds ``ctx`` valid slots, the ring
    decode model equals ``chip_smoke.bound_ms`` of
    ``chip_smoke.ring_work``'s bytes and operations, and the exponentials'
    term chip_smoke also weighs stays below it."""
    q = torch.zeros(B, K, G, hd, dtype=dtype)
    k = torch.zeros(B, C, K, hd, dtype=torch.int8 if quant else dtype)
    tok = torch.full((B, C), -1, dtype=torch.int32)
    tok[:, :ctx] = torch.arange(ctx, dtype=torch.int32)
    pos = torch.full((B,), ctx, dtype=torch.int32)
    nbytes, nops, exps = chip_smoke.ring_work(q, k, tok, pos, None, quant)
    want = chip_smoke.bound_ms(nbytes, nops, dtype)[0] * 1e3
    assert exps / chip_smoke.SFU_PER_S * 1e6 < want
    assert tuning.decode_cost_model_us(
        B=B, K=K, G=G, hd=hd, ctx=ctx, C=C, quant=quant,
        dtype=dtype) == pytest.approx(want, rel=1e-12)
