"""The threefry port (``repro_torch.rng``) is bit-exact with ``jax.random``
in its default partitionable mode, for the calls the engines make
(``fold_in`` included: the sharded engine's folded noise)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng

SEEDS = [0, 7, 123_456_789, 2**31 + 3, 2**32 + 5]


def _key_pair(key):
    return tuple(int(x) for x in np.asarray(key))


def test_partitionable_mode_is_the_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    jk = jax.random.PRNGKey(seed)
    tk = rng.PRNGKey(seed)
    assert _key_pair(jk) == tk
    for num in (2, 3, 7):
        want = [tuple(map(int, row)) for row in
                np.asarray(jax.random.split(jk, num))]
        assert rng.split(tk, num) == want
    # the per-iteration chain: key, k_it = split(key); split(k_it)
    for _ in range(4):
        jk, j_it = jax.random.split(jk)
        tk, t_it = rng.split(tk)
        assert _key_pair(jk) == tk and _key_pair(j_it) == t_it
        assert [_key_pair(x) for x in jax.random.split(j_it)] == \
            rng.split(t_it)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 3, 7, 2**31 + 5, 2**32 - 1])
def test_fold_in(seed, data):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    assert _key_pair(jk) == rng.fold_in(rng.PRNGKey(seed), data)
    # the folded noise of one shard: fold the rank in, split, draw
    jn, jm = jax.random.split(jk)
    tn, tm = rng.split(rng.fold_in(rng.PRNGKey(seed), data))
    want = np.asarray(jax.random.uniform(jn, (9, 5), jnp.float32, 0.0, 1e-7))
    got = rng.uniform(tn, (9, 5), 0.0, 1e-7, device="cpu")
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("offset_rows", [0, 1, 5, 31])
def test_uniform_offset_is_a_slice(offset_rows):
    """A shard's rows of a replicated draw: ``offset`` shifts the counters,
    so the slice of the whole draw comes out bit for bit."""
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (40, 6)))
    got = rng.uniform(rng.PRNGKey(4), (8, 6), device="cpu",
                      offset=offset_rows * 6)
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        want[offset_rows:offset_rows + 8].view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (65, 7), (192, 130), (3, 2)])
@pytest.mark.parametrize("hi", [1.0, 1e-7, 3.0])
def test_uniform_bits(seed, shape, hi):
    lo = 0.0
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         jnp.float32, lo, hi))
    got = rng.uniform(rng.PRNGKey(seed), shape, lo, hi, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_blocked_generation_keeps_the_bits(monkeypatch):
    """The counter is the flat index, so generating in row blocks (here
    forced far smaller than the output) changes no bit."""
    key = rng.split(rng.PRNGKey(3))[1]
    whole = rng.uniform(key, (97, 33), device="cpu")
    monkeypatch.setattr(rng, "_BLOCK", 100)
    blocked = rng.uniform(key, (97, 33), device="cpu")
    np.testing.assert_array_equal(whole.numpy().view(np.uint32),
                                  blocked.numpy().view(np.uint32))
    np.testing.assert_array_equal(
        rng.random_bits(key, (97, 33), "cpu").numpy(),
        np.asarray(jax.random.bits(jax.random.split(
            jax.random.PRNGKey(3))[1], (97, 33), jnp.uint32)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", [2, 7, 32, 130])
def test_randint(seed, k):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (1001,),
                                         0, k, dtype=jnp.int32))
    got = rng.randint(rng.PRNGKey(seed), (1001,), 0, k, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_wide_span():
    """A span above 2**16 exercises the wrapping uint32 multiplier."""
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.randint(key, (500,), -5, 3_000_000_000 // 2,
                                         dtype=jnp.int32))
    got = rng.randint(rng.PRNGKey(9), (500,), -5, 3_000_000_000 // 2,
                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("block", [7, 1 << 24])
def test_uniform_many_is_each_keys_draw(monkeypatch, block):
    """Drawing for a list of keys in one pass gives every key's own bits
    (and ``jax.random.uniform``'s), whatever the block size; the keys may
    come as an ``(nb, 2)`` int64 tensor of their words."""
    monkeypatch.setattr(rng, "_BLOCK", block)
    keys = [rng.split(rng.PRNGKey(s))[1] for s in SEEDS]
    shape, tie = (13, 5), 1e-6
    many = rng.uniform_many(keys, shape, 0.0, tie, device="cpu")
    words = rng.uniform_many(torch.tensor(keys, dtype=torch.int64), shape,
                             0.0, tie, device="cpu")
    assert many.shape == (len(keys),) + shape
    for b, key in enumerate(keys):
        one = rng.uniform(key, shape, 0.0, tie, device="cpu")
        want = np.asarray(jax.random.uniform(
            jnp.asarray(key, jnp.uint32), shape, jnp.float32, 0.0, tie))
        for got in (many[b], words[b]):
            assert torch.equal(got.view(torch.int32), one.view(torch.int32))
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          want.view(np.int32))
