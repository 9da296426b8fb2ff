"""The port's synthetic Markov token stream (`repro_torch.data.tokens`)
beside the JAX package's.  The draws differ (torch's generators against
JAX's threefry), so the two streams are held to the same structure:
shape and dtype, a fixed table of ``branching`` successors a token
(the share of transitions that go to a token's ``branching`` most
frequent successors), about 2 % uniform resets, and uniform use of the
vocabulary."""
import jax
import numpy as np
import pytest
import torch

from repro.data import make_token_dataset as jax_make_token_dataset
from repro_torch.data import make_token_dataset

V, N, L, BRANCH = 64, 64, 512, 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors, so that the suite's
    parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _top_share(seqs: np.ndarray, branching: int) -> float:
    """Share of transitions a → b with b among a's ``branching`` most
    frequent successors."""
    counts = np.zeros((V, V), np.int64)
    np.add.at(counts, (seqs[:, :-1].ravel(), seqs[:, 1:].ravel()), 1)
    top = np.sort(counts, axis=1)[:, -branching:].sum()
    return float(top / counts.sum())


@pytest.fixture(scope="module")
def streams():
    jseqs = np.asarray(jax_make_token_dataset(jax.random.PRNGKey(1), V, N,
                                              L))
    tseqs = make_token_dataset(1, V, N, L, device="cpu")
    return jseqs, tseqs


def test_shape_dtype_and_range(streams):
    jseqs, tseqs = streams
    assert tseqs.dtype == torch.int32 and tuple(tseqs.shape) == (N, L + 1)
    assert tseqs.shape == jseqs.shape and str(jseqs.dtype) == "int32"
    assert int(tseqs.min()) >= 0 and int(tseqs.max()) < V


def test_successor_table_structure_as_jax(streams):
    """Both streams send about 98 % of transitions along a token's table
    of 8 successors (resets land there 8/64 of the time too, and a
    table may repeat a successor): a uniform stream would send 8/64."""
    jseqs, tseqs = streams
    j, t = _top_share(jseqs, BRANCH), _top_share(tseqs.numpy(), BRANCH)
    assert 0.97 <= j <= 1.0 and 0.97 <= t <= 1.0
    assert abs(j - t) <= 0.01
    # With one successor a token, the table's structure shows as much
    # less than the top-8 share.
    assert _top_share(tseqs.numpy(), 1) < 0.5


def test_vocabulary_is_used_uniformly(streams):
    """Starts and resets are uniform and the table random: every token
    appears, none more than 3x its fair share."""
    _, tseqs = streams
    freq = np.bincount(tseqs.numpy().ravel(), minlength=V) / tseqs.numel()
    assert (freq > 0).all() and freq.max() < 3.0 / V


def test_seeds_and_generators():
    """The same seed gives the same stream, a generator seeded alike the
    same as the int, another seed another stream; ``branching`` and a
    large vocabulary are taken."""
    a = make_token_dataset(5, V, 8, 16, device="cpu")
    assert torch.equal(a, make_token_dataset(5, V, 8, 16, device="cpu"))
    assert torch.equal(a, make_token_dataset(torch.Generator().manual_seed(5),
                                             V, 8, 16, device="cpu"))
    assert not torch.equal(a, make_token_dataset(6, V, 8, 16, device="cpu"))
    b = make_token_dataset(0, 4096, 4, 8, branching=2, device="cpu")
    assert tuple(b.shape) == (4, 9) and int(b.max()) < 4096
