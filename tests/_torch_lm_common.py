"""Helpers of the port's LM tests (tests/test_torch_lm*.py,
test_torch_serve.py): the relative-norm bar and the perturbed JAX
parameters both packages are given."""
import jax
import numpy as np
import torch


def rel(got, want) -> float:
    """||got - want|| / ||want|| (0 for two zero arrays)."""
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    norm = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (norm if norm else 1.0))


def close(got, want, tol=1e-5):
    err = rel(got, want)
    assert err <= tol, err


def perturbed(tree, rng, scale=0.3):
    """The numpy tree with every constant leaf (zero biases, unit scales,
    Λ = 0.7, the zero gate) moved by N(0, scale²), so every parameter
    matters; each leaf keeps its dtype."""
    def move(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.flat[0]):
            a = (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(move, tree)
