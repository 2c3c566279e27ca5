"""The port's token pipeline (``data/tokens.py``) against the JAX
package's: the same batches byte for byte (tokens and labels: values,
dtypes and shapes), at the full qwen3-8b vocabulary and at a reduced one,
for two seeds."""
import numpy as np
import pytest

import _torch_threads  # noqa: F401

from repro.data import tokens as jtokens
from repro_torch.data import TokenStream, synthetic_token_batches


def _same(got, want):
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("vocab,seq,batch", [(151_936, 128, 8),
                                             (512, 17, 3)])
def test_token_stream_equals_jax(seed, vocab, seq, batch):
    it = iter(TokenStream(vocab, seq, batch, seed=seed))
    jit = iter(jtokens.TokenStream(vocab, seq, batch, seed=seed))
    for _ in range(5):
        got, want = next(it), next(jit)
        _same(got, want)
        half = seq // 2
        np.testing.assert_array_equal(got["tokens"][:, half:2 * half],
                                      got["tokens"][:, :half])
        np.testing.assert_array_equal(got["labels"],
                                      np.roll(got["tokens"], -1, axis=1))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_token_batches_equal_jax(seed):
    got = synthetic_token_batches(512, 32, 4, 5, seed=seed)
    want = jtokens.synthetic_token_batches(512, 32, 4, 5, seed=seed)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _same(g, w)
