"""The port's ``dist/compression.py`` against the JAX package's, no ranks.

Both packages get the same seeded numpy inputs and run op by op (the JAX
package quantizes a payload eagerly, at the wire boundary outside
``shard_map``). ``torch.round`` and ``jnp.round`` both round half to even,
so the sparse payload's q8, scale and residual, and the dense path's int8
round trip, are compared bit for bit; top-k error feedback keeps the same
entries and conserves ``grads + state`` exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compression as J
from repro_torch.dist import compression as T

CAP = 64


def _bits(x):
    x = np.asarray(x)
    return x.dtype, x.shape, x.view(np.uint8).tobytes()


def _payload(seed):
    rng = np.random.default_rng(seed)
    val = (rng.standard_normal((2, 3, CAP))
           * rng.uniform(0.01, 100.0, (2, 3, 1))).astype(np.float32)
    nnz = rng.integers(0, CAP + 1, (2, 3)).astype(np.int32)
    nnz[0, 0], nnz[1, 2] = 0, CAP             # an empty and a full tile
    resid = (rng.standard_normal((2, 3, CAP)) * 0.05).astype(np.float32)
    # ties: values that land exactly halfway between two int8 steps
    val[1, 0, :4] = np.float32(127.0) * np.asarray([1, 0.5 / 127, 2.5 / 127,
                                                     -3.5 / 127], np.float32)
    return val, nnz, resid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_resid", [False, True])
@pytest.mark.parametrize("with_nnz", [False, True])
def test_quantize_payload_bitwise(seed, with_resid, with_nnz):
    val, nnz, resid = _payload(seed)
    r = resid if with_resid else None
    n = nnz if with_nnz else None
    want = J.quantize_payload(jnp.asarray(val),
                              None if n is None else jnp.asarray(n),
                              None if r is None else jnp.asarray(r))
    got = T.quantize_payload(torch.from_numpy(val),
                             None if n is None else torch.from_numpy(n),
                             None if r is None else torch.from_numpy(r))
    for w, g in zip(want, got):
        assert _bits(g.numpy()) == _bits(w)
    q8, scale, new_resid = (g.numpy() for g in got)
    assert q8.dtype == np.int8 and scale.dtype == np.float32
    assert scale.shape == (2, 3)
    if with_nnz:
        pad = np.arange(CAP) >= nnz[..., None]
        assert not q8[pad].any() and not new_resid[pad].any()
    # the error-feedback contract, and one rounding step at most
    e = val + (resid if with_resid else 0)
    live = np.arange(CAP) < (nnz if with_nnz
                             else np.full((2, 3), CAP))[..., None]
    deq = T.dequantize_payload(*got[:2]).numpy()
    np.testing.assert_array_equal(np.where(live, deq + new_resid, 0),
                                  np.where(live, e, 0))
    assert (np.abs(new_resid) <= scale[..., None] / 2 * (1 + 1e-6)).all()


def test_dequantize_payload_bitwise():
    val, nnz, _ = _payload(3)
    q8, scale, _ = J.quantize_payload(jnp.asarray(val), jnp.asarray(nnz))
    want = J.dequantize_payload(q8, scale)
    got = T.dequantize_payload(torch.from_numpy(np.array(q8)),
                               torch.from_numpy(np.array(scale)))
    assert _bits(got.numpy()) == _bits(want)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": [rng.standard_normal(16).astype(np.float32) * 1e-3,
                  np.zeros(4, np.float32)]}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def test_int8_quantize_bitwise():
    tree = _tree(0)
    want = J.int8_quantize(_to(tree, jnp.asarray))
    got = T.int8_quantize(_to(tree, torch.from_numpy))
    assert isinstance(got, dict) and isinstance(got["b"], list)
    for w, g in zip(_leaves(want), _leaves(_to(got, lambda t: t.numpy()))):
        assert _bits(g) == _bits(w)
    # the round trip's error: half an int8 step of max|x|
    for x, g in zip(_leaves(tree), _leaves(_to(got, lambda t: t.numpy()))):
        assert np.abs(g - x).max() <= np.abs(x).max() / 254 * (1 + 1e-6)


@pytest.mark.parametrize("frac", [0.01, 0.25])
def test_topk_error_feedback(frac):
    jinit, jcomp = J.make_topk_error_feedback(frac)
    tinit, tcomp = T.make_topk_error_feedback(frac)
    jstate = jinit(_to(_tree(0), jnp.asarray))
    tstate = tinit(_to(_tree(0), torch.from_numpy))
    for step in range(3):
        grads = _tree(10 + step)
        jkept, jstate_n = jcomp(_to(grads, jnp.asarray), jstate)
        tkept, tstate_n = tcomp(_to(grads, torch.from_numpy), tstate)
        for tk, ts, jk, g, s in zip(
                _leaves(_to(tkept, lambda t: t.numpy())),
                _leaves(_to(tstate_n, lambda t: t.numpy())),
                _leaves(jkept), _leaves(grads),
                _leaves(_to(tstate, lambda t: t.numpy()))):
            # kept + new_state == grads + state, exactly
            np.testing.assert_array_equal(tk + ts, g + s)
            # the same entries kept as JAX, with the same values
            np.testing.assert_array_equal(tk != 0, np.asarray(jk) != 0)
            assert _bits(tk) == _bits(jk)
        jstate, tstate = jstate_n, tstate_n
