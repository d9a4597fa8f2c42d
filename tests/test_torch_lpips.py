"""The port's LPIPS against hma_tpu's, on the CPU in fp32: the same seeded
weights (the port's state dict in the `lpips` package's layout, through
hma_tpu's own `load_lpips_torch_weights`, under both head-key forms) and
the same numpy images give the same distances, VGG16 at 32² and AlexNet at
64², B 2; d(x, x) = 0; the state dict's layout; `make_lpips_fn` on uint8."""

import jax
import numpy as np
import pytest
import torch

from hma_tpu.metrics.lpips import LPIPS as JaxLPIPS
from hma_tpu.metrics.lpips import load_lpips_torch_weights as jax_load_lpips
from hma_tpu.metrics.lpips import make_lpips_fn as jax_make_lpips_fn
import torch_port_helpers  # noqa: F401  (one torch thread a test process)
from hma_tpu_torch.metrics.lpips import LPIPS, load_lpips_torch_weights, make_lpips_fn

# fp32 on both sides, relative to the distance: the convs sum in other
# orders; the CPU reads 3.3e-7 (VGG) and 1.3e-7 (AlexNet)
TOL = 5e-6
SIZES = {"vgg": 32, "alex": 64}


def _state(net, seed=0):
    """The port's net from `seed` with every head weight drawn too (not
    ones), as a numpy state dict."""
    model = LPIPS(net, device="cpu", generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    for k in sd:
        if k.startswith("lin"):
            sd[k] = rng.uniform(0, 1, sd[k].shape).astype(np.float32)
        elif k.endswith("bias"):
            sd[k] = 0.05 * rng.normal(size=sd[k].shape).astype(np.float32)
    return sd


def _images(rng, size, n=2):
    return rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def _jax_distance(net, sd, x, y):
    params = jax_load_lpips(JaxLPIPS(net=net), sd)
    return np.asarray(jax.jit(JaxLPIPS(net=net).apply)(params, x, y))


@pytest.mark.parametrize("net", ["vgg", "alex"])
@pytest.mark.parametrize("key_form", ["lin", "lins"])
def test_lpips_matches_jax(net, key_form):
    sd = _state(net)
    if key_form == "lins":  # the lpips package's newer head keys
        sd = {("lins." + k[3:] if k.startswith("lin") else k): v for k, v in sd.items()}
    rng = np.random.default_rng(1)
    x, y = _images(rng, SIZES[net]), _images(rng, SIZES[net])
    model = load_lpips_torch_weights(LPIPS(net, device="cpu"),
                                     {k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(y).permute(0, 3, 1, 2)).numpy()
    want = _jax_distance(net, sd, x, y)
    assert got.shape == (2,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_identity_and_layout(net):
    model = LPIPS(net, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    n_convs = 13 if net == "vgg" else 5
    convs = [k for k in sd if k.startswith("net.") and k.endswith(".weight")]
    assert len(convs) == n_convs and len(sd) == 2 * n_convs + 5
    first = "net.slice1.0.weight"
    last = "net.slice5.28.weight" if net == "vgg" else "net.slice5.10.weight"
    assert first in sd and last in sd
    assert sd["lin0.model.1.weight"].shape == (1, 64, 1, 1)
    assert torch.equal(sd["lin4.model.1.weight"], torch.ones_like(sd["lin4.model.1.weight"]))
    x = torch.from_numpy(_images(np.random.default_rng(2), SIZES[net])).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert torch.all(model(x, x) == 0)
        assert torch.all(model(x, x.flip(-1)) > 0)


def test_load_refuses_a_state_dict_that_does_not_fit():
    sd = {k: torch.from_numpy(v) for k, v in _state("alex").items()}
    with pytest.raises(RuntimeError, match="Missing"):
        load_lpips_torch_weights(LPIPS("alex", device="cpu"),
                                 {k: v for k, v in sd.items() if k != "lin2.model.1.weight"})
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_lpips_torch_weights(LPIPS("vgg", device="cpu"), sd)
    # the scaling layer's buffers of an lpips file are ignored, as hma_tpu ignores them
    load_lpips_torch_weights(LPIPS("alex", device="cpu"),
                             {**sd, "scaling_layer.shift": torch.zeros(1, 3, 1, 1)})


def test_make_lpips_fn_takes_uint8_like_jax():
    sd = _state("alex", seed=3)
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    y = np.clip(x.astype(np.int32) + rng.integers(-40, 40, x.shape), 0, 255).astype(np.uint8)
    fn = make_lpips_fn({k: torch.from_numpy(v) for k, v in sd.items()}, net="alex",
                       device="cpu")
    got = fn(x, y)
    want = np.asarray(jax_make_lpips_fn(jax_load_lpips(JaxLPIPS(net="alex"), sd),
                                        net="alex")(x, y))
    assert isinstance(got, np.ndarray) and got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    np.testing.assert_array_equal(fn(torch.from_numpy(x), x), np.zeros(2, np.float32))
