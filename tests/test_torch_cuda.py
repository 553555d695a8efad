"""The port's CUDA kernels on the card (marked ``gpu``; they skip without
a CUDA device).  This file imports no JAX, so it runs on the machine with
the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs
(float32 to 1e-4, bfloat16 against the plain version in float32 on the
same rounded inputs to 2e-2, int8 pools to 1e-4), the wrappers refuse
what the kernels do not take, and a small engine run on the card
launches both kernels.
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


def test_wrappers_count_launches_and_refuse_bad_operands(dev):
    (q, kp, vp, pt, pos0), _, _, _ = _inputs(dev, torch.float32, False)
    ops.reset_launches()
    ops.paged_extend_attention(q, kp, vp, pt, pos0)
    ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, pt, pos0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"paged_decode": 1, "paged_extend": 1}
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
    assert ops.LAUNCHES == {"paged_decode": 1, "paged_extend": 1}


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
    assert min(ops.LAUNCHES.values()) > 0, ops.LAUNCHES
    eng.pool.check()
