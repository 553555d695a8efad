"""The split page walk of ``csrc/paged_decode.cu`` and ``paged_extend.cu``,
on the CPU.

Both paged kernels tile the R = Sx * G query rows of a (request, kv head)
(row r is lane r // G, query head r % G, at position pos0 + r // G) and
split each tile's attendable range

    [max(0, p_first - window + 1), min(p_last, NP * ps - 1)]

into ``splits`` segments of whole stages counted from its start: of its n
stages, segment s takes stages [s * n // splits, (s + 1) * n // splits),
and a segment without a stage is empty.  Each block writes its rows'
unnormalized (acc, m, l), and the combine adds the splits in split order:

    out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,  M = max m_s,

skipping splits with l = 0; a row with none is zeros.  ``split_paged``
below is a plain PyTorch mirror of that arithmetic.  It is held, on
numpy-seeded inputs, against the port's plain versions
(``repro_torch.kernels.ref``) and the JAX oracles
(``repro.kernels.ref.paged_decode_attention_ref`` and
``paged_extend_attention_ref``) to 1e-5 in float32: float32 and int8
pools, a window that cuts a segment, unmapped pages inside the range, an
empty row, more splits than stages, R not a multiple of the tile, and Sx 1
extend equal to decode.  The JAX oracle softmaxes a row with no valid
slot into a uniform average, so such rows are compared with the port's
zeros only.  A variant that rounds P to bf16 before P.V, as the
tensor-core extend does, stays within the card's 2e-2 of the float32
oracle.  ``cuda_lib.paged_splits`` and the tile sizes are checked at
reflect_demo_100m's and recurrentgemma-9b's decode, verify and chunk
shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_quant as JQ
from repro.kernels import ref as jref
from repro_torch.kernels import cuda_lib, ref

TOL = 1e-5


def segment(t_first, t_last, stage, splits, split):
    """``paged::segment``: split ``split``'s slots of [t_first, t_last]."""
    if t_first > t_last:
        return t_first, t_last
    n = (t_last - t_first + stage) // stage
    lo, hi = split * n // splits, (split + 1) * n // splits
    return t_first + lo * stage, min(t_last, t_first + hi * stage - 1)


def split_paged(q, k_pool, v_pool, page_table, pos0, splits, tile_rows,
                stage, *, window=None, k_scale=None, k_zero=None,
                v_scale=None, bf16_p=False):
    """Paged extend as the split kernels compute it: q [B, Sx, K, G, hd]
    (decode: Sx = 1), pools [P, ps, K, hd] (int8 with [P, ps, K] scales),
    page_table [B, NP], pos0 [B]; rows in tiles of ``tile_rows``, ranges
    in stages of ``stage`` slots.  ``bf16_p`` rounds P to bf16 before
    P.V (the sums l stay float32), as the tensor-core extend does."""
    B, Sx, K, G, hd = q.shape
    R, T = Sx * G, page_table.shape[1] * k_pool.shape[1]
    kf, vf = ref._dequant(ref._gather(k_pool, page_table),
                          ref._gather(v_pool, page_table),
                          *(None if s is None else ref._gather(s, page_table)
                            for s in (k_scale, k_zero, v_scale)))
    kf, vf = kf.float(), vf.float()                        # [B, T, K, hd]
    qr = q.float().permute(0, 2, 1, 3, 4).reshape(B, K, R, hd)
    scores = torch.einsum("bkrd,btkd->bkrt", qr, kf) * hd ** -0.5
    t = torch.arange(T)
    mapped = torch.repeat_interleave(page_table >= 0, k_pool.shape[1], 1)
    pos = pos0.long()[:, None] + torch.arange(R) // G       # [B, R]
    valid = mapped[:, None, :] & ref._in_window(t[None, None, :],
                                                pos[..., None], window)
    out = torch.zeros(B, K, R, hd)
    for b in range(B):
        for row0 in range(0, R, tile_rows):
            rows = slice(row0, min(R, row0 + tile_rows))
            p_first, p_last = int(pos[b, rows][0]), int(pos[b, rows][-1])
            t_last = min(p_last, T - 1)
            t_first = max(0, p_first - window + 1) if window else 0
            parts = []
            for s in range(splits):
                lo, hi = segment(t_first, t_last, stage, splits, s)
                seg = torch.zeros(T, dtype=torch.bool)
                seg[max(lo, 0):hi + 1] = lo <= hi
                ok = (valid[b, rows] & seg)[None]          # [1, r, T]
                sc = scores[b, :, rows].masked_fill(~ok, float("-inf"))
                m = sc.amax(dim=-1)                        # -inf: no slot
                p = torch.where(ok, torch.exp(sc - m[..., None]), 0.0)
                pv = p.bfloat16().float() if bf16_p else p
                acc = torch.einsum("krt,tkd->krd", pv, vf[b])
                parts.append((acc, m, p.sum(dim=-1)))
            M = torch.stack([torch.where(l > 0, m, float("-inf"))
                             for _, m, l in parts]).amax(dim=0)
            o = torch.zeros_like(parts[0][0])
            L = torch.zeros_like(M)
            for acc, m, l in parts:                        # split order
                e = torch.where(l > 0, torch.exp(m - M), 0.0)
                L = L + e * l
                o = o + e[..., None] * acc
            out[b, :, rows] = torch.where(
                L[..., None] > 0, o / L[..., None].clamp_min(1e-30), 0.0)
    return (out.reshape(B, K, Sx, G, hd).permute(0, 2, 1, 3, 4)
            .to(q.dtype))


def _inputs(seed, B, Sx, K, G, hd, ps, NP, quant, *, holes=False,
            first=False):
    """Scattered pages, unmapped tails past each row's last lane and
    positions anywhere in the table; the last row is empty.  ``holes``
    unmaps every third page from page 2 to the middle, inside every row's
    range; ``first`` puts row 0's lane 0 at position 0 (a row of one
    slot)."""
    rng = np.random.default_rng(seed)
    P = B * NP + 3
    q = rng.normal(size=(B, Sx, K, G, hd)).astype(np.float32)
    kp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    pt = rng.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
    top = NP * ps - Sx
    pos0 = rng.integers(top // 2, top + 1, size=B).astype(np.int32)
    if first:
        pos0[0] = 0
    if holes:
        pt[:, 2:NP // 2:3] = -1
    for b in range(B):
        pt[b, (pos0[b] + Sx + ps - 1) // ps:] = -1
    pt[B - 1] = -1
    jargs = [jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp)]
    jsc = {}
    if quant:
        kq, ks, kz = JQ.quantize_k(jargs[1])
        vq, vs = JQ.quantize_v(jargs[2])
        jargs[1:] = [kq, vq]
        jsc = {"k_scale": ks, "k_zero": kz, "v_scale": vs}
    jargs += [jnp.asarray(pt), jnp.asarray(pos0)]
    targs = [torch.from_numpy(np.array(a)) for a in jargs]
    return jargs, jsc, targs, {n: torch.from_numpy(np.array(a))
                               for n, a in jsc.items()}


def _seen(targs, window):
    """[B, Sx] lanes with at least one valid slot."""
    q, kp, _, pt, pos0 = targs
    Sx, ps = q.shape[1], kp.shape[1]
    t = torch.arange(pt.shape[1] * ps)
    mapped = torch.repeat_interleave(pt >= 0, ps, 1)[:, None, :]
    pos = pos0.long()[:, None] + torch.arange(Sx)
    return (mapped & ref._in_window(t, pos[..., None], window)).any(-1)


def _check(jargs, jsc, targs, tsc, splits, tile_rows, stage, window):
    got = split_paged(*targs, splits, tile_rows, stage, window=window, **tsc)
    want = ref.paged_extend_attention_ref(*targs, window=window, **tsc)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    jwant = torch.from_numpy(np.array(jref.paged_extend_attention_ref(
        *jargs, window=window, **jsc)))
    seen = _seen(targs, window)
    assert seen.any() and not seen.all()
    torch.testing.assert_close(got[seen], jwant[seen], atol=TOL, rtol=TOL)
    assert not got[~seen].any()                    # the port's zeros
    return got


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("B,Sx,K,G,hd,ps,NP,splits,tile,stage,holes", [
    # verify step: 15 rows in one 64-row tile, 64-slot key tiles
    (3, 5, 2, 3, 64, 16, 24, 9, 64, 64, True),
    # prefill chunk: 96 rows in one 128-row tile
    (3, 32, 2, 3, 64, 16, 24, 4, 128, 64, True),
    # the float32 walk's 16-row tiles of a 96-row chunk, page size 5
    (3, 32, 2, 3, 64, 5, 60, 2, 16, 64, False),
    # MQA G 16 at hd 32: 160 rows in two 128-row tiles, 7 splits
    (3, 10, 1, 16, 32, 16, 20, 7, 128, 64, True),
    # more splits than stages: 64 segments of a <= 320-slot range
    (3, 5, 2, 3, 32, 16, 20, 64, 64, 64, False),
    # one split: the unsplit walk
    (3, 5, 2, 3, 64, 16, 24, 1, 64, 64, True),
])
def test_split_paged_extend_matches_references(B, Sx, K, G, hd, ps, NP,
                                               splits, tile, stage, holes,
                                               window, quant):
    """Window 48 against 64-slot stages cuts the first segment of every
    tile; ``holes`` unmaps pages inside every range."""
    jargs, jsc, targs, tsc = _inputs(NP + splits + Sx, B, Sx, K, G, hd, ps,
                                     NP, quant, holes=holes)
    _check(jargs, jsc, targs, tsc, splits, tile, stage, window)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("G,hd,splits,stage", [
    (3, 64, 9, 64),               # reflect_demo_100m's decode
    (16, 32, 33, 32),             # recurrentgemma-9b's G 16, 32-slot stages
    (4, 32, 40, 128),             # more splits than stages
])
def test_split_paged_decode_matches_references(G, hd, splits, stage, window,
                                               quant):
    """Decode is extend with Sx 1: the mirror on q [B, 1, K, G, hd] equals
    both packages' paged-decode oracles, and row 0, at position 0, has one
    slot."""
    jargs, jsc, targs, tsc = _inputs(G + splits, 4, 1, 2, G, hd, 16, 20,
                                     quant, holes=True, first=True)
    got = _check(jargs, jsc, targs, tsc, splits, 16, stage, window)[:, 0]
    q, kp, vp, pt, pos0 = targs
    want = ref.paged_decode_attention_ref(q[:, 0], kp, vp, pt, pos0,
                                          window=window, **tsc)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    jq, jkp, jvp, jpt, jpos = jargs
    jwant = torch.from_numpy(np.array(jref.paged_decode_attention_ref(
        jq[:, 0], jkp, jvp, jpt, jpos, window=window, **jsc)))
    torch.testing.assert_close(got[:-1], jwant[:-1], atol=TOL, rtol=TOL)
    assert not got[-1].any()                       # the empty row


def test_split_paged_one_slot_and_all_empty_rows():
    """A row at position 0 sees slot 0 alone: its output is that slot's V
    whatever the split; an all-unmapped table gives zeros."""
    jargs, jsc, targs, tsc = _inputs(7, 3, 1, 2, 3, 64, 16, 8, False,
                                     first=True)
    q, kp, vp, pt, pos0 = targs
    for splits in (1, 5, 40):
        got = split_paged(*targs, splits, 16, 64)
        torch.testing.assert_close(
            got[0, 0], vp[int(pt[0, 0])][0][:, None].expand(2, 3, 64),
            atol=TOL, rtol=TOL)
    pt[:] = -1
    assert not split_paged(*targs, 9, 64, 64).any()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("Sx,G,hd,tile,stage", [
    (5, 3, 64, 64, 64),           # demo verify
    (32, 3, 64, 128, 64),         # demo chunk
    (32, 16, 256, 128, 32),       # recurrentgemma chunk, 4 tiles
])
def test_split_paged_bf16_p_within_card_tolerance(Sx, G, hd, tile, stage,
                                                  quant):
    """P rounded to bf16 before P.V (the tensor-core extend's rounding)
    stays within the card's bf16 tolerance, 2e-2, of the float32
    oracle."""
    jargs, jsc, targs, tsc = _inputs(Sx + G, 2, Sx, 1, G, hd, 16, 40,
                                     quant, holes=True)
    got = split_paged(*targs, 9, tile, stage, bf16_p=True, **tsc)
    want = ref.paged_extend_attention_ref(*targs, **tsc)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=0)
    exact = split_paged(*targs, 9, tile, stage, **tsc)
    assert not torch.equal(got, exact)             # P really was rounded


@pytest.mark.parametrize("B,K,rows,hd,code,tile,splits", [
    (8, 4, 3, 64, 1, None, 9),        # demo decode: 9 x 32 blocks
    (8, 1, 16, 256, 1, None, 33),     # recurrentgemma decode: 33 x 8
    (8, 4, 15, 64, 1, 64, 9),         # demo verify (Sx 5), bf16
    (8, 4, 15, 64, 3, 64, 9),         # the same on an int8 pool
    (8, 4, 96, 64, 1, 128, 9),        # demo chunk (Sx 32), bf16
    (8, 1, 512, 256, 1, 128, 9),      # recurrentgemma chunk: 4 tiles
    (8, 4, 96, 64, 0, 16, 2),         # demo chunk, float32: 6 tiles
    (8, 1, 512, 256, 2, 16, 2),       # recurrentgemma chunk, int8 + f32 q
    (1, 1, 3, 64, 1, None, 32),       # capped: 2048 slots of 64-slot stages
    (2, 1, 3, 64, 1, None, 1),        # a table shorter than two stages
])
def test_paged_splits(B, K, rows, hd, code, tile, splits):
    """Decode rows are one tile of G; ``tile`` is the extend's rows per
    block for dtype ``code``."""
    n_slots = 64 if splits == 1 else 2048
    if tile is None:
        tiles = 1
    else:
        assert cuda_lib.extend_rows(hd, rows, code) == tile
        tiles = -(-rows // tile)
    got = cuda_lib.paged_splits(B, K, tiles, n_slots, hd)
    assert got == splits
    assert got == 1 or n_slots // got >= cuda_lib.stage_slots(hd)
    assert B * K * tiles * got <= 2 * cuda_lib.SMS + B * K * tiles
    assert cuda_lib.partials_shape(B, K, rows, hd, got) == (B, K, got, rows,
                                                            hd + 2)


def test_tensor_core_block_fits_shared_memory():
    """The tensor-core extend's block at hd 256 (128 rows, Q and two
    stages of 32-slot K and V tiles in bf16, a flag a slot) with a
    128-page table fits the card's shared memory; the float32 walk's
    too."""
    assert cuda_lib.tc_smem_bytes(256, 128, 128) == 2 * 256 * (128 + 128) \
        + 2 * 32 + 4 * 128
    assert cuda_lib.tc_smem_bytes(256, 128, 128) <= cuda_lib.MAX_SMEM_BYTES
    assert cuda_lib.smem_bytes(256, 16, 128) <= cuda_lib.MAX_SMEM_BYTES
    with pytest.raises(ValueError):
        cuda_lib.check_smem(cuda_lib.tc_smem_bytes(256, 128, 60000), 60000)
