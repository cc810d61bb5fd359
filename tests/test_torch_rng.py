"""The port's counter RNG against the reference's, on random u32 words.

hash_u32, uniform and categorical must agree bit for bit; exponential goes
through ``log``, whose last bit differs between torch and XLA for some
inputs, so it is held to rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as jrng
from repro_torch.core import rng as trng

EDGE_WORDS = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint64)


def _words(seed, n=20_000):
    rs = np.random.default_rng(seed)
    w = rs.integers(0, 2**32, size=(3, n), dtype=np.uint64)
    w[:, : len(EDGE_WORDS)] = EDGE_WORDS  # both ends of the u32 range
    return w


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 2**32 - 1, 12345])
def test_hash_and_uniform_bitwise(seed):
    w = _words(seed % 97)
    jw = [jnp.asarray(x.astype(np.uint32)) for x in w]
    h_j = np.asarray(jrng.hash_u32(seed, jrng.CONTACT, *jw))
    h_t = trng.hash_u32(seed, trng.CONTACT, *[_t(x) for x in w]).numpy()
    np.testing.assert_array_equal(h_t, h_j.astype(np.int64))
    u_j = np.asarray(jrng.uniform(jnp.uint32(seed), jrng.INFECT, *jw))
    u_t = trng.uniform(_t(np.asarray(seed, np.uint64)), trng.INFECT, *[_t(x) for x in w])
    np.testing.assert_array_equal(u_t.numpy(), u_j)
    assert u_t.dtype == torch.float32 and float(u_t.min()) > 0.0


def test_stream_ids_unchanged():
    for name in ("CONTACT", "INFECT", "TRANSITION", "DWELL", "SEED_CHOICE",
                 "VISIT_SAMPLE", "INIT_ATTR", "TEST"):
        assert int(getattr(jrng, name)) == getattr(trng, name), name


def test_categorical_bitwise():
    from repro.core import disease

    cum = disease.covid_model().cum_trans
    w = _words(3)[0]
    state = np.random.default_rng(4).integers(0, cum.shape[0], w.shape[0])
    c_j = np.asarray(jrng.categorical(jnp.asarray(cum)[state], 7, jrng.TRANSITION, 9,
                                      jnp.asarray(w.astype(np.uint32))))
    c_t = trng.categorical(torch.as_tensor(cum)[state], 7, trng.TRANSITION, 9, _t(w))
    np.testing.assert_array_equal(c_t.numpy(), c_j)


def test_exponential_within_log_ulp():
    w = _words(5)[0]
    mean = np.random.default_rng(6).uniform(1.0, 6.0, w.shape[0]).astype(np.float32)
    e_j = np.asarray(jrng.exponential(jnp.asarray(mean), 11, jrng.DWELL, 3,
                                      jnp.asarray(w.astype(np.uint32))))
    e_t = trng.exponential(torch.as_tensor(mean), 11, trng.DWELL, 3, _t(w)).numpy()
    np.testing.assert_allclose(e_t, e_j, rtol=1e-6, atol=0)


def test_np_uniform_matches_reference():
    ids = np.arange(5000)
    np.testing.assert_array_equal(
        trng.np_uniform(3, trng.INIT_ATTR, 7, ids),
        jrng.np_uniform(3, jrng.INIT_ATTR, 7, ids),
    )
