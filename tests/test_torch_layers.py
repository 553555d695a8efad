"""The port's layers and int8 KV quantizers against the JAX package, on the
same numpy inputs: norms, RoPE, the three MLP activations and the
embedding to 1e-6; the quantizers bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_quant as JQ
from repro.models import layers as JL
from repro_torch.kernels import kv_quant as Q
from repro_torch.models import layers as L

TOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_rmsnorm_and_heads():
    r = _rng()
    x = r.normal(size=(2, 5, 48)).astype(np.float32)
    s = r.normal(size=(48,)).astype(np.float32)
    _close(L.rmsnorm(torch.tensor(s), torch.tensor(x), 1e-6),
           JL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-6))
    xh = r.normal(size=(2, 5, 3, 32)).astype(np.float32)
    sh = r.normal(size=(32,)).astype(np.float32)
    _close(L.rmsnorm_heads(torch.tensor(sh), torch.tensor(xh), 1e-6),
           JL.rmsnorm_heads(jnp.asarray(sh), jnp.asarray(xh), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    r = _rng(1)
    x = r.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = (np.arange(7)[None, :] + np.array([[3], [250]])).astype(np.int32)
    _close(L.rope(torch.tensor(x), torch.tensor(pos), theta),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_mlp(act):
    r = _rng(2)
    d, ff = 32, 64
    x = r.normal(size=(3, 4, d)).astype(np.float32)
    w = {k: (r.normal(size=shape) * 0.2).astype(np.float32)
         for k, shape in (("wi", (d, ff)), ("wg", (d, ff)), ("wo", (ff, d)))}
    if act != "swiglu":
        del w["wg"]
    m = L.MLP(d, ff, act)
    m.load_state_dict({k: torch.tensor(v) for k, v in w.items()})
    _close(L.mlp(m, torch.tensor(x), act),
           JL.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
                  act))


def test_embed_unembed():
    r = _rng(3)
    table = r.normal(size=(50, 16)).astype(np.float32)
    tok = r.integers(0, 50, size=(2, 6)).astype(np.int32)
    want = jnp.asarray(table)[jnp.asarray(tok)]
    _close(L.embed(torch.tensor(table), torch.tensor(tok), torch.float32),
           want)
    w = r.normal(size=(16, 50)).astype(np.float32)
    x = r.normal(size=(2, 6, 16)).astype(np.float32)
    _close(L.unembed(torch.tensor(w), torch.tensor(x)),
           jnp.einsum("...d,dv->...v", jnp.asarray(x), jnp.asarray(w)))


def test_init_params_recipe():
    """normal(0, scale / sqrt(fan_in)) for matrices, ones for norms; one
    seed gives one model."""
    m = L.MLP(256, 512, "swiglu")
    n = L.RMSNorm(256)
    mod = torch.nn.ModuleDict({"mlp": m, "ln": n})
    L.init_params(mod, torch.Generator().manual_seed(0))
    assert torch.equal(n.scale, torch.ones(256))
    assert abs(float(m.wi.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert abs(float(m.wo.std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5
    again = L.MLP(256, 512, "swiglu")
    L.init_params(again, torch.Generator().manual_seed(0))
    assert torch.equal(again.wi, m.wi)


@pytest.mark.parametrize("shape", [(4, 16, 2, 64), (3, 8, 32)])
def test_quantizers_bit_exact(shape):
    r = _rng(4)
    x = (r.normal(size=shape) * r.uniform(0.01, 10.0, size=shape[:-1] + (1,))
         ).astype(np.float32)
    x[0, 0] = 0.5                                  # degenerate constant row
    kq, ks, kz = Q.quantize_k(torch.tensor(x))
    jkq, jks, jkz = JQ.quantize_k(jnp.asarray(x))
    vq, vs = Q.quantize_v(torch.tensor(x))
    jvq, jvs = JQ.quantize_v(jnp.asarray(x))
    for got, want in ((kq, jkq), (ks, jks), (kz, jkz), (vq, jvq),
                      (vs, jvs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        Q.dequantize_k(kq, ks, kz).numpy(),
        np.asarray(JQ.dequantize_k(jkq, jks, jkz)))
    np.testing.assert_array_equal(Q.dequantize_v(vq, vs).numpy(),
                                  np.asarray(JQ.dequantize_v(jvq, jvs)))
