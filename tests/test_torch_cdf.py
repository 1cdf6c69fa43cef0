"""The port's CDF-MLP bank (``ops.cdf_bank_forward``) against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version. Weights come
from numpy with a seed, or from the reference's own ``build_cdf_bank``, and
go to both packages; ``cdf_params_from_reference`` carries a bank across.
The tolerance is the reference's own kernel test's, ``atol=2e-6`` on
outputs in [0, 1]: the two frameworks sum the hidden layers' products in
different orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.cdf import build_cdf_bank  # noqa: E402
from repro.data.synth import make_dataset as jmake_dataset  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

from test_torch_cases import CDF_EDGE_X, CDF_SWEEP, cdf_params, with_edge_points  # noqa: E402

ATOL = 2e-6


def _forward(params, x):
    """The port's bank output on the CPU, from numpy weights and points."""
    tp = ops.cdf_params_from_reference(params, device="cpu")
    return ops.cdf_bank_forward(tp, torch.from_numpy(np.asarray(x, np.float32))).numpy()


@pytest.mark.parametrize("n,b,h", CDF_SWEEP)
def test_cdf_bank_forward_matches_reference(n, b, h):
    rng = np.random.default_rng(n + b + h)
    params = cdf_params(rng, b, h)
    x = rng.uniform(0, 1, n).astype(np.float32)
    got = _forward(params, x)
    assert got.dtype == np.float32 and got.shape == (n, b)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    np.testing.assert_allclose(got, np.asarray(jops.cdf_bank_forward(jp, jnp.asarray(x))),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jref.cdf_mlp_ref(jp, jnp.asarray(x))),
                               atol=ATOL, rtol=0)
    assert ((got >= 0) & (got <= 1)).all()


@pytest.mark.parametrize("n,b,h", CDF_SWEEP)
def test_cdf_bank_forward_at_edge_points_matches_reference(n, b, h):
    """NaN, both infinities, both zeros and far points (``CDF_EDGE_X``)
    among uniform ones: the port equals the reference's kernel (interpret
    mode) and its oracle to the tolerance, NaN where they give NaN. A NaN
    point gives NaN in every column, since ReLU propagates it; an infinite
    one gives NaN wherever infinities of both signs meet in a sum."""
    rng = np.random.default_rng(n + b + h + 1)
    params = cdf_params(rng, b, h)
    x = with_edge_points(rng, rng.uniform(0, 1, max(n, CDF_EDGE_X.size)))
    got = _forward(params, x)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    for want in (jops.cdf_bank_forward(jp, jnp.asarray(x)), jref.cdf_mlp_ref(jp, jnp.asarray(x))):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0, equal_nan=True)
    assert np.isnan(got[np.isnan(x)]).all()
    assert not np.isnan(got[np.isfinite(x)]).any()


def test_cdf_bank_in_chunks_equals_one_pass(monkeypatch):
    """One point at a time gives the one-pass answer to the tolerance (the
    matrix products may sum in another order at another batch size)."""
    rng = np.random.default_rng(2)
    tp = ops.cdf_params_from_reference(cdf_params(rng, 7, 16), device="cpu")
    x = torch.from_numpy(rng.uniform(0, 1, 301).astype(np.float32))
    whole = ref.cdf_mlp_ref(tp, x)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 1)
    torch.testing.assert_close(ref.cdf_mlp_ref(tp, x), whole, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def bank3():
    """A bank trained by the reference with three hidden layers, the
    kernel's format, on a small dataset."""
    ds = jmake_dataset("fs", n=1500, seed=3)
    bank = build_cdf_bank(ds, n_hidden_layers=3, n_steps=20, n_points=32, seed=1)
    assert bank.nn_params is not None
    return ds, bank


def test_bank_from_build_cdf_bank_carries_across(bank3):
    ds, bank = bank3
    params = {k: np.asarray(v) for k, v in bank.nn_params.items()}
    assert params["w0"].shape[1:] == (1, 16) and params["w3"].shape[1:] == (16, 1)
    x = np.concatenate([ds.locs[:, 0], [0.0, 1.0]]).astype(np.float32)
    got = _forward(params, x)
    want = np.asarray(jops.cdf_bank_forward(bank.nn_params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got.shape == (x.size, 2 * int((bank.cls == 2).sum()))


def test_two_hidden_layer_bank_is_refused():
    """``build_cdf_bank``'s default (two hidden layers) has no ``w3``: it is
    not the kernel's input, and the carry-across says so."""
    ds = jmake_dataset("fs", n=800, seed=4)
    bank = build_cdf_bank(ds, n_steps=2, n_points=16)
    params = {k: np.asarray(v) for k, v in bank.nn_params.items()}
    assert "w3" not in params
    with pytest.raises(ValueError, match="n_hidden_layers=3"):
        ops.cdf_params_from_reference(params, device="cpu")


def test_cdf_entry_points_follow_the_device_rules():
    """No device: the weights go to the card, which raises without one; a
    CPU tensor never launches the kernel."""
    params = cdf_params(np.random.default_rng(5), 3, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.cdf_params_from_reference(params)
    _build.reset_launch_counts()
    tp = ops.cdf_params_from_reference(params, device="cpu")
    x = torch.linspace(0, 1, 9)
    assert torch.equal(ops.cdf_bank_forward(tp, x), ref.cdf_mlp_ref(tp, x))
    assert not any(_build.launch_counts().values())
