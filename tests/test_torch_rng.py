"""The threefry port (``repro_torch.rng``) is bit-exact with ``jax.random``
in its default partitionable mode, for the calls the engines make
(``fold_in`` included: the sharded engine's folded noise).  On the CPU the
draws take the plain int64 path; the card's threefry kernel is held to it
by ``tests/test_torch_gpu.py`` and its dispatch here."""
import ast
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.kernels import _build, threefry

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


# ---- the threefry kernel's dispatch (``kernels/threefry.py``) -------------
# On the CPU ``uniform`` and ``uniform_many`` take the plain int64 path and
# launch nothing; on a CUDA device they hand the kernel one launch each.
# Without a card, the kernel's contract is written out below in numpy
# (uint32 and float32 arithmetic) and stands in for the launch.

CASES = [((1,), (0.0, 1.0), 0), ((31,), (0.0, 1e-7), 32 * 5),
         ((97, 33), (-2.0, 3.0), 0), ((40, 6), (0.0, 1e-7), 2**32 - 17),
         ((1001,), (0.0, 1.0), 2**32 + 3)]


def _contract_rounds(x0, x1, rot):
    for r in rot:
        x0 = x0 + x1
        x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
    return x0, x1


def kernel_contract(keys, n, lo, span, *, device, offset=0):
    """What one launch of ``uniform_threefry`` computes, from its
    docstring: threefry2x32 of each key over the counters ``offset + i``
    split as (hi, lo) words, ``y0 ^ y1``, the mantissa trick, then ``max(f
    * span + lo, lo)`` rounded after each op."""
    assert torch.device(device).type == "cuda"
    single = not isinstance(keys, torch.Tensor)
    words = np.array([keys] if single else keys.numpy(), dtype=np.uint64)
    k0 = words[:, :1].astype(np.uint32)
    k1 = words[:, 1:].astype(np.uint32)
    c = np.uint64(offset) + np.arange(n, dtype=np.uint64)[None, :]
    x0 = (c >> np.uint64(32)).astype(np.uint32) + k0
    x1 = (c & np.uint64(0xFFFFFFFF)).astype(np.uint32) + k1
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    for i in range(5):
        x0, x1 = _contract_rounds(x0, x1, rng._ROT[i % 2])
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    bits = x0 ^ x1
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    x = (f - np.float32(1.0)) * np.float32(span) + np.float32(lo)
    x = np.where(np.isnan(x), x, np.maximum(x, np.float32(lo)))
    got = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return got[0] if single else got


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape,bounds,offset", CASES)
def test_uniform_on_cpu_is_the_plain_path(shape, bounds, offset):
    key = rng.split(rng.PRNGKey(offset + 11))[1]
    n0 = threefry.uniform_threefry.launches
    got = rng.uniform(key, shape, *bounds, device="cpu", offset=offset)
    want = rng._uniform_plain(key, shape, *bounds, device="cpu",
                              offset=offset)
    assert torch.equal(_bits(got), _bits(want))
    assert threefry.uniform_threefry.launches == n0


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.0, 1e-7), (-2.0, 3.0)])
@pytest.mark.parametrize("nb", [1, 3, 16])
def test_uniform_many_on_cpu_is_the_plain_path(nb, bounds):
    keys = [rng.split(rng.PRNGKey(100 + b)) for b in range(nb)]
    words = torch.tensor(keys, dtype=torch.int64)[:, 0]   # strided view
    want = rng._uniform_many_plain([k[0] for k in keys], (13, 7), *bounds,
                                   device="cpu")
    n0 = threefry.uniform_threefry.launches
    for given in ([k[0] for k in keys], words):
        got = rng.uniform_many(given, (13, 7), *bounds, device="cpu")
        assert torch.equal(_bits(got), _bits(want))
    assert threefry.uniform_threefry.launches == n0


@pytest.mark.parametrize("shape,bounds,offset", CASES)
def test_card_dispatch_gives_the_plain_bits(monkeypatch, shape, bounds,
                                            offset):
    """``uniform`` on a CUDA device hands the kernel the key, the flat
    size, rng's float32 bounds and the offset: with the kernel's contract
    in its place the result is the plain path's, bit for bit (and
    ``jax.random.uniform``'s for minval 0)."""
    calls = []
    monkeypatch.setattr(rng, "uniform_threefry",
                        lambda *a, **kw: calls.append(a) or
                        kernel_contract(*a, **kw))
    key = rng.split(rng.PRNGKey(offset + 5))[0]
    got = rng.uniform(key, shape, *bounds, device="cuda", offset=offset)
    assert len(calls) == 1 and got.shape == shape
    want = rng._uniform_plain(key, shape, *bounds, device="cpu",
                              offset=offset)
    assert torch.equal(_bits(got), _bits(want))
    if bounds[0] == 0.0 and offset == 0:
        ref = np.asarray(jax.random.uniform(
            jnp.asarray(key, jnp.uint32), shape, jnp.float32, *bounds))
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      ref.view(np.int32))


@pytest.mark.parametrize("nb", [1, 3, 16])
def test_card_dispatch_of_many_keys(monkeypatch, nb):
    """``uniform_many`` on a CUDA device: one kernel call for the whole
    ``(nb, 2)`` key tensor, as given (a strided view is not copied)."""
    calls = []
    monkeypatch.setattr(rng, "uniform_threefry",
                        lambda *a, **kw: calls.append(a[0]) or
                        kernel_contract(*a, **kw))
    keys = [rng.split(rng.PRNGKey(300 + b)) for b in range(nb)]
    words = torch.tensor(keys, dtype=torch.int64)[:, 1]
    got = rng.uniform_many(words, (17, 3), 0.0, 1e-6, device="cuda")
    assert len(calls) == 1 and calls[0] is words
    want = rng._uniform_many_plain([k[1] for k in keys], (17, 3), 0.0, 1e-6,
                                   device="cpu")
    assert got.shape == (nb, 17, 3)
    assert torch.equal(_bits(got), _bits(want))


def test_threefry_wrapper_refuses_the_cpu():
    n0 = threefry.uniform_threefry.launches
    with pytest.raises(ValueError):
        threefry.uniform_threefry(rng.PRNGKey(1), 8, 0.0, 1.0, device="cpu")
    with pytest.raises(ValueError):
        threefry.uniform_threefry(torch.zeros((2, 2), dtype=torch.int64), 8,
                                  0.0, 1.0, device="cpu")
    assert threefry.uniform_threefry.launches == n0


def test_threefry_kernel_is_built_and_has_no_fallback():
    """The source is one of the built ones, has the wrapper's C entry and
    rotates by funnel shifts; neither the wrapper nor ``rng`` falls back
    from the card to the plain path."""
    for module in (threefry, rng):
        tree = ast.parse(inspect.getsource(module))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert "threefry" in _build.SOURCES
    text = (_build.CSRC / "threefry.cu").read_text()
    for fn in threefry._SIGNATURES:
        assert f'extern "C" int {fn}(' in text, fn
    assert "__funnelshift_l" in text and "0x1BD11BDAu" in text


def test_first_load_builds_every_source(monkeypatch):
    """Loading one library not built yet starts the build of every source,
    one nvcc each together, so the new source costs a fresh checkout no
    serial compile."""
    built = []
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build",
                        lambda names, need: built.append((names, need)))
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(
                            threefry_uniform=types.SimpleNamespace()))
    _build.load("threefry", threefry._SIGNATURES)
    assert built == [(_build.SOURCES, "threefry")]
    _build.load("threefry", threefry._SIGNATURES)   # loaded: no rebuild
    assert built == [(_build.SOURCES, "threefry")]


def _fake_nvcc(tmp_path, broken: str) -> str:
    """An nvcc stand-in that writes its ``-o`` file, or fails with a
    message for the source named ``broken``."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        'for a; do case "$a" in *.cu) src="$a";; esac; done\n'
        'out=""; prev=""\n'
        'for a; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        f'case "$src" in *{broken}.cu) echo "error in $src"; exit 1;; esac\n'
        'echo built > "$out"\n')
    script.chmod(0o755)
    return str(script)


@pytest.mark.parametrize("broken", ["pregel_combine", "threefry"])
def test_one_failed_source_blocks_only_itself(monkeypatch, tmp_path, broken):
    """A source that fails to compile is not installed and raises only
    where it is needed: the sources that compiled are installed, a build
    that needs another source returns, one that needs it (or needs every
    source) raises with its compiler output."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    fake = _fake_nvcc(tmp_path, broken)
    monkeypatch.setattr(_build, "nvcc", lambda: fake)
    other = next(n for n in _build.SOURCES if n != broken)
    built = _build.build(_build.SOURCES, need=other)
    assert sorted(built) == sorted(n for n in _build.SOURCES if n != broken)
    for name in _build.SOURCES:
        assert _build.library_path(name).exists() == (name != broken)
    for need in (broken, None):
        with pytest.raises(RuntimeError, match=f"error in .*{broken}.cu"):
            _build.build(_build.SOURCES, need=need)
    assert _build.build(_build.SOURCES, need=other) == {}
