"""The port's CUDA kernels on the card (marked ``gpu``; they skip without
a CUDA device).  This file imports no JAX, so it runs on the machine with
the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs
(float32 to 1e-4, bfloat16 against the plain version in float32 on the
same rounded inputs to 2e-2, int8 pools to 1e-4; the scans to 1e-4, and
the RG-LRU scan bit for bit), the wrappers refuse what the kernels do not
take, and small engine runs on the card launch the kernels of their
models' paths.
"""
import pytest
import torch

from repro_torch.kernels import kv_quant, ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, act, quant, B=3, Sx=6, K=2, G=3, hd=64, ps=16, NP=8,
            seed=0):
    """Scattered pages, unmapped tails, positions mid-page and one empty
    batch slot; returns CUDA operands and float32 CPU copies."""
    g = torch.Generator().manual_seed(seed)
    P = B * NP + 4
    q = torch.randn(B, Sx, K, G, hd, generator=g).to(act)
    kp = torch.randn(P, ps, K, hd, generator=g)
    vp = torch.randn(P, ps, K, hd, generator=g)
    pt = torch.randperm(P, generator=g)[:B * NP].view(B, NP).to(torch.int32)
    pos0 = torch.tensor([37, 90, NP * ps - Sx], dtype=torch.int32)[:B]
    for b in range(B):
        pt[b, (int(pos0[b]) + Sx + ps - 1) // ps:] = -1
    pt[B - 1] = -1
    sc = {}
    if quant:
        kp, ks, kz = kv_quant.quantize_k(kp)
        vp, vs = kv_quant.quantize_v(vp)
        sc = {"k_scale": ks, "k_zero": kz, "v_scale": vs}
    else:
        kp, vp = kp.to(act), vp.to(act)
    cpu = [q, kp, vp, pt, pos0]
    cuda = [t.to(dev) for t in cpu]
    f32 = [t.float() if t.dtype == torch.bfloat16 else t for t in cpu]
    return cuda, {k: v.to(dev) for k, v in sc.items()}, f32, sc


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8",
                                  "int8+bf16"])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("ps,NP", [(16, 8), (5, 40)])
def test_kernels_match_plain(dev, mode, window, hd, ps, NP):
    """Page size 5 divides no stage width, so pages straddle stages."""
    act = torch.bfloat16 if "bf" in mode else torch.float32
    quant = mode.startswith("int8")
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    cuda, sc, f32, sc_cpu = _inputs(dev, act, quant, hd=hd, ps=ps, NP=NP)
    q, kp, vp, pt, pos0 = cuda
    fq, fkp, fvp, fpt, fpos = f32
    got = ops.paged_extend_attention(q, kp, vp, pt, pos0, window=window,
                                     **sc)
    want = ref.paged_extend_attention_ref(fq, fkp, fvp, fpt, fpos,
                                          window=window, **sc_cpu)
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)
    got = ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, pt, pos0,
                                     window=window, **sc)
    want = ref.paged_decode_attention_ref(fq[:, 0], fkp, fvp, fpt, fpos,
                                          window=window, **sc_cpu)
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [None, 48, 2048])
def test_kernels_match_plain_mqa_hd256(dev, mode, window):
    """recurrentgemma-9b's local attention: K 1, G 16, hd 256."""
    act = torch.bfloat16 if mode == "bfloat16" else torch.float32
    tol = 2e-2 if act == torch.bfloat16 else 1e-4
    cuda, sc, f32, sc_cpu = _inputs(dev, act, mode == "int8", B=3, Sx=32,
                                    K=1, G=16, hd=256, ps=16, NP=160)
    q, kp, vp, pt, pos0 = cuda
    fq, fkp, fvp, fpt, fpos = f32
    got = ops.paged_extend_attention(q, kp, vp, pt, pos0, window=window,
                                     **sc)
    want = ref.paged_extend_attention_ref(fq, fkp, fvp, fpt, fpos,
                                          window=window, **sc_cpu)
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)
    got = ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, pt, pos0,
                                     window=window, **sc)
    want = ref.paged_decode_attention_ref(fq[:, 0], fkp, fvp, fpt, fpos,
                                          window=window, **sc_cpu)
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)


def _scan_inputs(B, S, D, N, seed):
    """Mamba scan operands as the model makes them: softplus step sizes,
    a negative A, a nonzero h0, and pad lanes (dt = 0) at the end of every
    row but the first."""
    g = torch.Generator().manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn(B, S, D, generator=g)
                                      - 2.0)
    n_valid = torch.tensor([S] + [max(1, S - 3 * b) for b in range(1, B)])
    dt = dt * (torch.arange(S)[None, :] < n_valid[:, None])[..., None]
    return (dt, torch.randn(B, S, N, generator=g),
            torch.randn(B, S, N, generator=g),
            torch.randn(B, S, D, generator=g),
            -torch.exp(0.5 * torch.randn(D, N, generator=g)),
            torch.randn(D, generator=g),
            torch.randn(B, D, N, generator=g), n_valid)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D,N", [(8, 32, 8192, 16), (3, 5, 300, 8),
                                     (2, 70, 256, 4), (8, 1, 8192, 16)])
def test_mamba_scan_matches_plain(dev, x_dtype, B, S, D, N):
    """falcon-mamba-7b's mixed-step and decode shapes, and ragged ones;
    the state after pad lanes is the state after the last valid token."""
    dt, Bm, Cm, x, A, Dsk, h0, n_valid = _scan_inputs(B, S, D, N, 0)
    x = x.to(x_dtype)
    args = [t.to(dev) for t in (dt, Bm, Cm, x, A, Dsk, h0)]
    y, h = ops.mamba_scan(*args)
    want_y, want_h = ref.mamba_scan_ref(dt, Bm, Cm, x.float(), A, Dsk, h0)
    torch.testing.assert_close(y.cpu(), want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h.cpu(), want_h, atol=1e-4, rtol=1e-4)
    for b in range(B):                        # pads leave h untouched
        nv = int(n_valid[b])
        _, hb = ref.mamba_scan_ref(dt[b:b + 1, :nv], Bm[b:b + 1, :nv],
                                   Cm[b:b + 1, :nv], x[b:b + 1, :nv].float(),
                                   A, Dsk, h0[b:b + 1])
        torch.testing.assert_close(h[b:b + 1].cpu(), hb, atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("B,S,W", [(8, 32, 4096), (3, 7, 300), (8, 1, 4096)])
def test_rglru_scan_matches_plain(dev, B, S, W):
    """recurrentgemma-9b's mixed-step and decode shapes and a ragged one,
    with identity pad lanes: the kernel rounds as the plain version does,
    so the two agree bit for bit."""
    g = torch.Generator().manual_seed(1)
    a = torch.sigmoid(torch.randn(B, S, W, generator=g))
    b = torch.randn(B, S, W, generator=g)
    a[1:, S // 2:], b[1:, S // 2:] = 1.0, 0.0
    h0 = torch.randn(B, W, generator=g)
    hs, h = ops.rglru_scan(a.to(dev), b.to(dev), h0.to(dev))
    want_hs, want_h = ref.rglru_scan_ref(a, b, h0)
    torch.testing.assert_close(hs.cpu(), want_hs, atol=0, rtol=0)
    torch.testing.assert_close(h.cpu(), want_h, atol=0, rtol=0)


def test_scan_wrappers_count_launches_and_refuse_bad_operands(dev):
    dt, Bm, Cm, x, A, Dsk, h0, _ = _scan_inputs(2, 4, 256, 8, 2)
    args = [t.to(dev) for t in (dt, Bm, Cm, x, A, Dsk, h0)]
    a = torch.rand(2, 4, 256, device=dev)
    ops.reset_launches()
    ops.mamba_scan(*args)
    ops.rglru_scan(a, a, a[:, 0].contiguous())
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba_scan"] == 1 and ops.LAUNCHES["rglru_scan"] == 1
    with pytest.raises(ValueError):          # state size the kernel lacks
        ops.mamba_scan(*args[:4], args[4][:, :5].contiguous(), args[5],
                       args[6][..., :5].contiguous())
    with pytest.raises(ValueError):          # bf16 step sizes
        ops.mamba_scan(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError):          # operands on two devices
        ops.mamba_scan(*args[:6], args[6].cpu())
    with pytest.raises(ValueError):          # non-contiguous decay
        ops.rglru_scan(a.transpose(0, 1), a, a[:, 0].contiguous())
    assert ops.LAUNCHES["mamba_scan"] == 1 and ops.LAUNCHES["rglru_scan"] == 1


def test_wrappers_count_launches_and_refuse_bad_operands(dev):
    (q, kp, vp, pt, pos0), _, _, _ = _inputs(dev, torch.float32, False)
    ops.reset_launches()
    ops.paged_extend_attention(q, kp, vp, pt, pos0)
    ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, pt, pos0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode"] == 1
    assert ops.LAUNCHES["paged_extend"] == 1
    with pytest.raises(ValueError):          # int64 page table
        ops.paged_extend_attention(q, kp, vp, pt.long(), pos0)
    with pytest.raises(ValueError):          # non-contiguous q
        ops.paged_decode_attention(q[:, 0], kp, vp, pt, pos0)
    with pytest.raises(ValueError):          # pool dtype != q dtype
        ops.paged_extend_attention(q, kp.bfloat16(), vp.bfloat16(), pt,
                                   pos0)
    with pytest.raises(ValueError):          # head_dim the kernels lack
        ops.paged_extend_attention(q[..., :48].contiguous(),
                                   kp[..., :48].contiguous(),
                                   vp[..., :48].contiguous(), pt, pos0)
    with pytest.raises(ValueError):          # operands on two devices
        ops.paged_extend_attention(q, kp.cpu(), vp, pt, pos0)
    assert ops.LAUNCHES["paged_decode"] == 1
    assert ops.LAUNCHES["paged_extend"] == 1


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_engine_on_card_launches_both_kernels(dev, kv_dtype):
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models.registry import build_model, get_smoke_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, Status

    m = build_model(get_smoke_config("reflect_demo_100m")).init(
        torch.Generator().manual_seed(0))
    eng = Engine(m, ServeConfig(max_batch=2, max_seq=128, page_size=16,
                                spec_decode=True, kv_dtype=kv_dtype),
                 device="cuda")
    ops.reset_launches()
    prompt = [1] + list(range(10, 22)) * 3
    reqs = [Request(prompt=list(prompt), max_new_tokens=12, eos_id=None)
            for _ in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.status is Status.DONE and len(r.output) == 12
               for r in reqs)
    assert ops.LAUNCHES["paged_decode"] > 0, ops.LAUNCHES
    assert ops.LAUNCHES["paged_extend"] > 0, ops.LAUNCHES
    eng.pool.check()


@pytest.mark.parametrize("arch,kernels", [
    ("falcon_mamba_7b", ("mamba_scan",)),
    ("recurrentgemma_9b", ("rglru_scan", "paged_extend", "paged_decode"))])
def test_engine_on_card_serves_recurrent_models(dev, arch, kernels):
    """Two reflection rounds of the smoke model on the card: every kernel
    of the model's path launches and round 2 hits the prefix cache."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models.registry import build_model, get_smoke_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, Status

    m = build_model(get_smoke_config(arch)).init(
        torch.Generator().manual_seed(0))
    eng = Engine(m, ServeConfig(max_batch=2, max_seq=128, page_size=8,
                                prefill_chunk=8), device="cuda")
    ops.reset_launches()
    convo = [1] + list(range(10, 50))
    for _ in range(2):
        r = Request(prompt=list(convo), max_new_tokens=6, eos_id=None)
        eng.submit(r)
        eng.run()
        assert r.status is Status.DONE and len(r.output) == 6
        convo += r.output + [99, 98]
    assert all(ops.LAUNCHES[k] > 0 for k in kernels), ops.LAUNCHES
    assert eng.prefix_cache.stats["hits"] > 0
    eng.pool.check()
