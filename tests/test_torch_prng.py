"""The port's threefry (``repro_torch.prng``) against ``jax.random`` as
the installed jax computes it (``jax_threefry_partitionable`` on).

Keys, split keys, random bits and uniforms must be bit-identical.  Gumbel
noise is ``-log(-log(u))`` and torch's ``log`` and XLA's may round one
ulp apart: within 1e-6 relative, plus 1e-6 absolute where the noise
crosses zero (one float32 ulp at |g| <= 8).  Categorical draws must
pick the same ids.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.bridge import key_from_reference  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

VOCAB = 152064                      # Qwen2.5's vocabulary
SHAPES = [(VOCAB,), (1, 1, VOCAB), (3, 5, 7)]


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _keys(n: int, seed: int = 11):
    """``n`` distinct jax keys and the same words as a port key batch."""
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(seed), i)
                      for i in range(n)])
    return keys, key_from_reference(np.asarray(keys))


@pytest.mark.parametrize("seed", [0, 1, 42, -3, 2 ** 31, 2 ** 32 + 5])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _words(jax.random.PRNGKey(seed)))


def test_seeds_out_of_32_bits_keep_only_the_low_word():
    """jax without x64: the high word is 0 for -3 and 2**32 + 5."""
    assert prng.PRNGKey(-3).tolist() == [0, 4294967293]
    assert prng.PRNGKey(2 ** 32 + 5).tolist() == [0, 5]


@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31, 2 ** 32 - 1])
def test_fold_in_matches_jax(data):
    key = jax.random.PRNGKey(1234)
    got = prng.fold_in(prng.PRNGKey(1234), data)
    np.testing.assert_array_equal(got.numpy(),
                                  _words(jax.random.fold_in(key, data)))


def test_batched_fold_in_matches_vmap():
    """One fold per slot at once, as ``decode_loop`` folds positions."""
    keys, kt = _keys(6)
    pos = np.asarray([0, 9, 17, 64, 383, 1000], np.uint32)
    want = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(pos))
    got = prng.fold_in(kt, torch.from_numpy(pos.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("num", [2, 3, (2, 3)])
def test_split_matches_jax(num):
    key = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(5), num).numpy(),
                                  _words(jax.random.split(key, num)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits_match_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    want = jax.random.bits(key, shape, jnp.uint32)
    got = prng.random_bits(key_from_reference(np.asarray(key)), shape)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_matches_jax_bit_for_bit(shape):
    key = jax.random.PRNGKey(77)
    kt = prng.PRNGKey(77)
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0)):
        want = np.asarray(jax.random.uniform(key, shape, minval=lo,
                                             maxval=hi))
        got = prng.uniform(kt, shape, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gumbel_matches_jax(shape):
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.gumbel(key, shape))
    got = prng.gumbel(prng.PRNGKey(9), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_categorical_per_slot_matches_jax_at_temperature_0_7():
    """Eight slots, each with its own key, over a Qwen-sized vocabulary
    (the reference's ``sample_tokens_per_slot``); the padded columns are
    masked before the draw."""
    keys, kt = _keys(8)
    rng = np.random.RandomState(0)
    logits = (rng.randn(8, 1, VOCAB + 128) * 3).astype(np.float32)
    want = ref_tf.sample_tokens_per_slot(jnp.asarray(logits), VOCAB, 0.7,
                                         keys)
    got = tf.sample_tokens(torch.from_numpy(logits), VOCAB, 0.7, kt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    direct = jax.vmap(lambda lg, k: jax.random.categorical(k, lg))(
        jnp.asarray(logits[..., :VOCAB]), keys)
    np.testing.assert_array_equal(
        prng.categorical(kt, torch.from_numpy(logits[..., :VOCAB])).numpy(),
        np.asarray(direct))


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_tokens_one_key_matches_reference(temperature):
    """One key for the whole (B, 1, V) batch, as admission samples."""
    key = jax.random.fold_in(jax.random.PRNGKey(3), 40)
    logits = np.random.RandomState(1).randn(3, 1, 640).astype(np.float32)
    want = ref_tf.sample_tokens(jnp.asarray(logits), 600, temperature, key)
    got = tf.sample_tokens(torch.from_numpy(logits), 600, temperature,
                           key_from_reference(np.asarray(key)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_key_bridge_rejects_what_is_not_a_key():
    with pytest.raises(ValueError, match="uint32"):
        key_from_reference(np.zeros(2, np.int32))
    assert key_from_reference(np.asarray(jax.random.PRNGKey(4))).tolist() \
        == [0, 4]
