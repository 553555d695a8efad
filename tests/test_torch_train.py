"""The port's training path (``repro_torch/train``, ``data/lm_data.py``,
``launch/train.py``) against the JAX package's, on the CPU.

* One train step on bridged weights (``params_from_jax``) of four smoke
  configs at float32 — dense, MoE (the router aux term), mamba and
  RG-LRU: the metrics of the reference's ``make_train_step`` (loss,
  xent, accuracy, router_aux, lr, grad_norm) to 1e-5 relative (grad_norm
  1e-4), and every gradient leaf of its loss to 1e-3 of that leaf's
  largest magnitude (float32 sums in another order through a whole
  model; the largest error seen is 2e-4, RG-LRU's).
* Twelve whole train steps, each step's loss to 1e-4 relative.
* AdamW and Adafactor over 3 steps on the same gradients, to 1e-6
  absolute plus 1e-5 relative, with the reference's stacked ``[R, d]``
  norm scales: Adafactor factors and clips per reference leaf, which a
  per-layer update does not reproduce.
* The mechanics of ``tests/test_train.py`` on the port: both optimizers
  lower the loss, microbatching, the chunked loss and its gradients,
  gradient clipping, the LR schedule, checkpoints, ``lm_data``; and
  ``remat`` gives the same loss and gradients.
* Checkpoints: the port writes the reference's bytes for the same tree
  (float32 and bfloat16), each package restores the other's file, its
  msgpack subset encodes as ``msgpack.packb(use_bin_type=True)`` does, and
  ``params_to_jax`` inverts ``params_from_jax`` for every registry arch.
* The launcher and the example on the CPU.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import lm_data as jlm
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_smoke_config as jsmoke
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.loop import make_loss_fn as jloss_fn
from repro.train.loop import make_train_step as jtrain_step
from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.data.lm_data import lm_batches
from repro_torch.models.registry import build_model, get_smoke_config
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import (chunked_xent, grads_of, init_opt_state,
                                    make_loss_fn, make_train_step,
                                    params_of, softmax_xent, to_device,
                                    trainable)

ARCHS = ("reflect_demo_100m", "granite_moe_1b_a400m", "falcon_mamba_7b",
         "recurrentgemma_9b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run long loops of small tensor
    operations, which wait on every thread of the pool, and the suite's
    parallel workers would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch="reflect_demo_100m", dtype="float32", seed=0):
    """(JAX model, JAX params, port model) on one weight set."""
    jcfg = jsmoke(arch).replace(dtype=dtype)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    model = build_model(get_smoke_config(arch).replace(dtype=dtype))
    model.load_state_dict(bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, model


def _batch(vocab, B=2, S=16, seed=0, mask=True):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if mask:
        m = np.ones((B, S), np.float32)
        m[-1, -3:] = 0.0
        b["loss_mask"] = m
    return b


def _ref_leaves(tree):
    """{path tuple: numpy leaf} of a JAX tree."""
    return {tuple(k.key if hasattr(k, "key") else k.idx for k in path):
            np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(state, cfg):
    """{path tuple: numpy leaf} of the port's tensors in the reference's
    tree (stacked)."""
    tree = bridge.reference_tree({k: v.detach() for k, v in state.items()},
                                 cfg)
    return {p: np.asarray(t.float().numpy())
            for p, t in ckpt._leaves(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    jm, params, model = _pair(arch)
    tkw = dict(remat=False, z_loss=1e-4, learning_rate=1e-3,
               warmup_steps=2)
    jt, tcfg = JTrainConfig(**tkw), TrainConfig(**tkw)
    cfg = model.cfg
    batch = _batch(cfg.vocab_size)

    def ref(p, b):
        (_, _), g = jax.value_and_grad(jloss_fn(jm, jm.cfg, jt),
                                       has_aux=True)(p, b)
        _, _, m = jtrain_step(jm, jm.cfg, jt)(p, jopt.opt_init(p, jt), b)
        return g, m

    jg, jmetrics = jax.jit(ref)(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    tparams = params_of(model)
    with trainable(model):
        loss, _ = make_loss_fn(model, cfg, tcfg)(to_device(batch, "cpu"))
        grads = grads_of(loss, tparams)
    metrics = make_train_step(model, cfg, tcfg)(
        init_opt_state(model, cfg, tcfg), batch)
    assert set(metrics) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(want),
                                   rtol=1e-4 if k == "grad_norm" else 1e-5,
                                   atol=1e-7, err_msg=k)
    want, got = _ref_leaves(jg), _port_leaves(grads, cfg)
    assert list(want) == list(got)
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max())
        assert err <= 1e-3 * float(np.abs(w).max()) + 1e-7, (path, err)


def test_train_steps_track_reference():
    """Twelve AdamW steps of the demo smoke config (float32) on bridged
    weights and the same task-corpus batches: each step's loss within
    1e-4 relative of the reference's (3e-6 seen).  At learning rate 1e-4:
    at 1e-3 float32 rounding differences are amplified step by step to
    1e-3 relative by step 8 in either package alone (random-init
    attention is near one-hot, ROADMAP C3), which says nothing about the
    port."""
    jm, params, model = _pair()
    kw = dict(remat=False, learning_rate=1e-4, warmup_steps=3,
              total_steps=12)
    jt, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstep = jax.jit(jtrain_step(jm, jm.cfg, jt))
    jstate = jopt.opt_init(params, jt)
    step = make_train_step(model, model.cfg, tcfg)
    state = init_opt_state(model, model.cfg, tcfg)
    want, got = [], []
    for b in lm_batches(32, 4, 12):
        params, jstate, m = jstep(params, jstate,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))
        got.append(float(step(state, b)["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference_over_3_steps(name):
    jm, params, model = _pair()
    kw = dict(optimizer=name, learning_rate=1e-2, warmup_steps=2,
              weight_decay=0.1)
    jt, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    cfg = model.cfg
    norm = np.asarray(params["scan"][0]["ln1"]["scale"])
    assert norm.ndim == 2 and norm.shape[0] > 1      # a stacked [R, d] leaf
    jstate = jopt.opt_init(params, jt)
    tparams = params_of(model)
    state = opt.opt_init(tparams, tcfg,
                         bridge.reference_groups(tparams, cfg))
    naive = build_model(cfg)                         # one leaf per layer
    naive.load_state_dict(model.state_dict())
    nstate = opt.opt_init(params_of(naive), tcfg)
    jupdate = jax.jit(lambda p, g, st: jopt.opt_update(p, g, st, jt))
    for step in range(3):
        g = _grads(params, step)
        params, jstate, jm_ = jupdate(params, g, jstate)
        tg = bridge.params_from_jax(g)
        m = opt.opt_update(tparams, tg, state, tcfg)
        opt.opt_update(params_of(naive), tg, nstate, tcfg)
        assert m["lr"] == pytest.approx(float(jm_["lr"]), rel=1e-7)
    want, got = _ref_leaves(params), _port_leaves(model.state_dict(), cfg)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=1e-6, rtol=1e-5,
                                   err_msg=str(path))
    if name == "adafactor":
        assert jstate["slots"]["scan"][0]["ln1"]["scale"]["vr"].shape == \
            norm.shape[:1]
        assert state["slots"][("scan", 0, "ln1", "scale")]["vr"].shape == \
            norm.shape[:1]
        naive_leaves = _port_leaves(naive.state_dict(), cfg)
        p = ("scan", 0, "ln1", "scale")
        assert np.abs(naive_leaves[p] - want[p]).max() > 1e-4


def test_adamw_groups_give_the_one_group_update(monkeypatch):
    """AdamW's multi-tensor ops run over groups of at most
    ``FOREACH_ELEMENTS`` elements (a larger tensor alone), which bounds
    their temporaries: groups of a few thousand elements give the same
    bits over 3 steps as one group over every tensor."""
    _, _, model = _pair()
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, weight_decay=0.1)
    small = build_model(model.cfg)
    small.load_state_dict(model.state_dict())
    params, sparams = params_of(model), params_of(small)
    state, sstate = opt.opt_init(params, tcfg), opt.opt_init(sparams, tcfg)
    monkeypatch.setattr(opt, "FOREACH_ELEMENTS", 5000)
    groups = opt._groups(sparams)
    assert len(groups) > 4 and sum(groups, []) == list(sparams)
    assert all(len(g) == 1 or sum(sparams[n].numel() for n in g) <= 5000
               for g in groups)
    for step in range(3):
        rng = np.random.default_rng(step)
        g = {n: torch.from_numpy(rng.standard_normal(p.shape)
                                 .astype(np.float32))
             for n, p in params.items()}
        monkeypatch.setattr(opt, "FOREACH_ELEMENTS", 1 << 40)
        opt.opt_update(params, g, state, tcfg)
        monkeypatch.setattr(opt, "FOREACH_ELEMENTS", 5000)
        opt.opt_update(sparams, g, sstate, tcfg)
    for n in params:
        assert torch.equal(params[n], sparams[n]), n
        assert torch.equal(state["v"][n], sstate["v"][n]), n


# ------------------------------------------------ tests/test_train.py's ten

def _setup(arch="reflect_demo_100m", **tkw):
    cfg = get_smoke_config(arch).replace(dtype="float32")
    tcfg = TrainConfig(**{**dict(remat=False, z_loss=0.0), **tkw})
    model = build_model(cfg).init(torch.Generator().manual_seed(0))
    return cfg, tcfg, model


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_decreases_loss(name):
    cfg, tcfg, model = _setup(optimizer=name, learning_rate=5e-3,
                              warmup_steps=1)
    step = make_train_step(model, cfg, tcfg)
    state = init_opt_state(model, cfg, tcfg)
    batch = _batch(cfg.vocab_size, B=4, S=32, mask=False)
    losses = [float(step(state, batch)["loss"]) for _ in range(12)]
    assert losses[-1] < losses[0] * 0.9
    if name == "adafactor":     # factored slots: no [r, c] second moment
        big = max(t.numel() for s in state["slots"].values()
                  for t in s.values())
        assert big < max(p.numel() for p in model.parameters())


def test_microbatch_equivalence():
    """Gradient accumulation == full-batch step (dense model)."""
    cfg, tcfg, model = _setup(learning_rate=1e-3)
    twin = build_model(cfg)
    twin.load_state_dict(model.state_dict())
    batch = _batch(cfg.vocab_size, B=8, S=16, mask=False)
    m1 = make_train_step(model, cfg, tcfg)(
        init_opt_state(model, cfg, tcfg), batch)
    tmb = TrainConfig(remat=False, z_loss=0.0, learning_rate=1e-3,
                      microbatch=2)
    m2 = make_train_step(twin, cfg, tmb)(init_opt_state(twin, cfg, tmb),
                                         batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    d = max(float((a - b).abs().max()) for a, b in
            zip(model.state_dict().values(), twin.state_dict().values()))
    assert d < 1e-4, f"param divergence {d}"


def test_chunked_xent_equals_full():
    cfg, tcfg, model = _setup()
    b = to_device(_batch(cfg.vocab_size, B=2, S=24, mask=False), "cpu")
    hidden, _ = model.forward(b, return_hidden=True)
    logits, _ = model.forward(b)
    full, fm = softmax_xent(logits, b["labels"], 0.0)
    for chunk in (6, 8, 24):
        c, cm = chunked_xent(model, hidden, b["labels"], chunk, 0.0)
        np.testing.assert_allclose(float(c), float(full), rtol=1e-5)
        np.testing.assert_allclose(float(cm["accuracy"]),
                                   float(fm["accuracy"]), rtol=1e-5)


@pytest.mark.parametrize("variant", ["chunked", "remat"])
def test_variant_gradients_match(variant):
    """The chunked loss (tcfg.loss_chunk) and remat (each block recomputed
    in the backward pass) give the plain loss's value and gradients."""
    cfg, tcfg, model = _setup()
    other = TrainConfig(remat=variant == "remat", z_loss=0.0,
                        loss_chunk=8 if variant == "chunked" else 0)
    b = to_device(_batch(cfg.vocab_size, B=2, S=24), "cpu")
    params = params_of(model)
    out = []
    with trainable(model):
        for t in (tcfg, other):
            loss, _ = make_loss_fn(model, cfg, t)(b)
            out.append((float(loss.detach()), grads_of(loss, params)))
    (l1, g1), (l2, g2) = out
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    for k in g1:
        np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_grad_clip():
    g = {"w": torch.full((10,), 100.0)}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert abs(float(opt.global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) > 100
    jg, jn = jopt.clip_by_global_norm({"w": jnp.full((10,), 100.0)}, 1.0)
    np.testing.assert_allclose(clipped["w"].numpy(), np.asarray(jg["w"]),
                               rtol=1e-6)


def test_checkpoint_roundtrip(tmp_path):
    cfg, tcfg, model = _setup()
    path = str(tmp_path / "ck.msgpack")
    ckpt.save_model(path, model, step=42)
    other = build_model(cfg).init(torch.Generator().manual_seed(1))
    assert ckpt.restore_model(path, other) == 42
    for (k, a), b in zip(model.state_dict().items(),
                         other.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_checkpoint_bf16_roundtrip(tmp_path):
    tree = {"x": torch.arange(8, dtype=torch.bfloat16) * 0.5}
    path = str(tmp_path / "ck.msgpack")
    ckpt.save(path, tree)
    restored, _ = ckpt.restore(path, tree)
    assert restored["x"].dtype == torch.bfloat16
    assert torch.equal(restored["x"], tree["x"])


def test_lm_data_pipeline_equals_reference():
    for b, jb in zip(lm_batches(seq_len=64, batch_size=2, steps=3),
                     jlm.lm_batches(seq_len=64, batch_size=2, steps=3)):
        assert b["tokens"].shape == (2, 64) and b["labels"].shape == (2, 64)
        # labels are tokens shifted by one within the packed stream
        assert (b["tokens"][:, 1:] == b["labels"][:, :-1]).all()
        for k in jb:
            assert b[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(b[k], jb[k])


def test_lr_schedule():
    tcfg = TrainConfig(learning_rate=1.0, warmup_steps=10, total_steps=100)
    assert opt.lr_schedule(tcfg, 0) < 0.11
    assert abs(opt.lr_schedule(tcfg, 10) - 1.0) < 1e-6
    assert opt.lr_schedule(tcfg, 100) < 0.2
    jt = JTrainConfig(learning_rate=1.0, warmup_steps=10, total_steps=100)
    for s in (0, 1, 7, 10, 33, 99, 100, 150):
        assert opt.lr_schedule(tcfg, s) == float(
            jopt.lr_schedule(jt, jnp.asarray(s)))


# ------------------------------------------------------------ checkpoints

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_bytes_match_reference(dtype, tmp_path):
    """Same tree, same bytes: the JAX tree saved by both packages, and the
    port's model (its bridged copy) saved by ``save_model``."""
    jm, params, _ = _pair()
    if dtype == "bfloat16":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                        params)
    cfg = get_smoke_config("reflect_demo_100m").replace(param_dtype=dtype)
    model = build_model(cfg)
    model.load_state_dict(bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    paths = [str(tmp_path / f"{n}.msgpack") for n in ("ref", "port",
                                                      "model")]
    jckpt.save(paths[0], params, step=7)
    ckpt.save(paths[1], jax.tree_util.tree_map(np.asarray, params), step=7)
    ckpt.save_model(paths[2], model, step=7)
    raw = [open(p, "rb").read() for p in paths]
    assert raw[0] == raw[1] == raw[2]


def test_checkpoints_restore_across_packages(tmp_path):
    jm, params, model = _pair()
    a, b = str(tmp_path / "a.msgpack"), str(tmp_path / "b.msgpack")
    jckpt.save(a, params, step=3)
    other = build_model(model.cfg)
    assert ckpt.restore_model(a, other) == 3
    for k, v in model.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k
    ckpt.save_model(b, model, step=5)
    restored, step = jckpt.restore(b, params)
    assert step == 5
    for x, y in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(params)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("arch", ["reflect_demo_100m", "granite_moe_1b_a400m",
                                  "falcon_mamba_7b", "recurrentgemma_9b",
                                  "qwen3_0_6b", "mixtral_8x7b"])
def test_params_to_jax_inverts_params_from_jax(arch):
    jm, params, model = _pair(arch)
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, params))
    got = jax.tree_util.tree_flatten_with_path(
        bridge.params_to_jax(model.state_dict(), model.cfg))
    assert want[1] == got[1]                         # same tree structure
    for (pw, w), (pg, g) in zip(want[0], got[0]):
        assert pw == pg and w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)


def test_msgpack_subset_encodes_as_msgpack():
    values = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
              2 ** 63, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
              -2 ** 31 - 1, -2 ** 63,
              "", "a" * 31, "a" * 32, "é" * 200, "b" * 256, "c" * 70000,
              b"", b"x" * 255, b"x" * 256, b"y" * 70000,
              list(range(15)), list(range(16)), list(range(70000)),
              {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
              {"nested": {"s": [1, 2], "b": b"\x00\xff"}}]
    for v in values:
        want = msgpack.packb(v, use_bin_type=True)
        assert ckpt.packb(v) == want
        assert ckpt.unpackb(want) == msgpack.unpackb(want, raw=False)


# ------------------------------------------------------- entry points

def test_train_launcher(capsys):
    from repro_torch.launch import train
    out = train.main(["--smoke", "--device", "cpu", "--steps", "3",
                      "--seq", "32", "--batch", "2"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert "final loss" in capsys.readouterr().out
    # --dryrun prints the reference's production plan and runs nothing
    assert train.main(["--dryrun", "--arch", "kimi_k2_1t_a32b"]) is None
    plan = capsys.readouterr().out.splitlines()
    assert plan[0].startswith("arch=kimi-k2") and "layers=61" in plan[0]
    assert plan[1] == ("train overrides: {'optimizer': 'adafactor', "
                       "'microbatch': 64, 'loss_chunk': 256}")
    assert plan[2].startswith("sharding rules: {'batch': ('pod', 'data')")
    assert "'embed': ('data',)" in plan[2]          # an FSDP arch
    assert plan[3] == ("meta-device dry run: python -m "
                       "repro_torch.launch.dryrun --arch kimi_k2_1t_a32b "
                       "--shape train_4k --mesh both")
    # whisper trains with zero frames beside each batch, as the
    # reference's launcher feeds them (its encoder in the prefix mode)
    out = train.main(["--smoke", "--device", "cpu", "--arch", "whisper_tiny",
                      "--steps", "3", "--seq", "16", "--batch", "2"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--smoke", "--steps", "1"])


def test_train_example_drops_the_loss_and_saves(tmp_path):
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "torch_train_100m",
        Path(__file__).resolve().parents[1] / "examples"
        / "torch_train_100m.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path = tmp_path / "demo.msgpack"
    out = mod.main(["--smoke", "--device", "cpu", "--steps", "60",
                    "--seq", "64", "--ckpt", str(path)])
    assert out["last"] < 0.7 * out["first"]
    other = build_model(out["model"].cfg)
    assert ckpt.restore_model(str(path), other) == 60
    assert os.path.getsize(path) > 0
