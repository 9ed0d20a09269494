"""The device terminal fold against the reference's: seeded numpy inputs
(sorted trie levels, per-row cursors, a frontier annotation and carried
columns) go through ``repro.core.backend._fold_body`` (JAX on the CPU, its
jnp fold loop over morsel chunks) and ``repro_torch.core.backend.
_fold_body`` (the ``frontier_fold`` wrapper's plain version on the CPU).
The new count, the morsel chunks, the annotation and the carried columns
are equal: exactly, or for ``sum_f32`` within ``rtol=1e-6`` (the two sum
a row's terms in other orders).

One fault of the reference shows here: its boolean fold reduces each chunk
with ``jax.ops.segment_max`` over int32, whose identity for a row with no
candidate in the chunk is -2^31, cast to True, so every row that a chunk
misses is OR-ed with True.  With leaf annotations (a kept candidate may
contribute False) the reference then derives True where every kept
contribution is False.  For boolean folds with leaf annotations the port
is held against the reference run in one chunk (no row missed), and the
chunked reference is shown to differ from it only by such False-to-True
flips."""
import numpy as np
import pytest
import torch

from repro.core import backend as jax_backend
from repro.core import semiring as jS
from repro_torch.core import backend as torch_backend
from repro_torch.core import semiring as tS

SEMIRINGS = ("count", "sum_f32", "min_plus", "max_min", "boolean")
CAP_IN, COUNT = 48, 40   # rows past COUNT are dead
MORSEL = 64


def _level(r, parents, max_len, universe, hub_len=None):
    """A trie level: sorted values under each of ``parents`` parents (CSR
    offsets), parent 0 of ``hub_len`` values if given."""
    lens = r.integers(0, max_len + 1, parents)
    if hub_len is not None:
        lens[0] = hub_len
    vals = [np.sort(r.choice(universe, size=n, replace=False)) for n in lens]
    offs = np.concatenate([[0], np.cumsum(lens)])
    return np.concatenate(vals).astype(np.int32), offs.astype(np.int32)


def _ann(r, sr_name, n):
    a = r.random(n).astype(np.float32) * 3
    if sr_name == "count":
        return np.floor(a).astype(np.int32)
    if sr_name == "boolean":
        return a > 1.0
    return a


def _inputs(seed, sr_name, n_probes, with_anns, hub):
    r = np.random.default_rng(seed)
    universe = 400 if not hub else 5000
    atoms = []
    for k in range(1 + n_probes):
        vals, offs = _level(r, 30, 60, universe,
                            hub_len=3000 if hub and k == 0 else None)
        cursor = r.integers(0, 30, CAP_IN).astype(np.int32)
        if hub:
            cursor[::7] = 0
        atoms.append((vals, offs, cursor))
    leaf = [_ann(r, sr_name, len(a[0])) if with_anns and k != 1 else None
            for k, a in enumerate(atoms)]
    ann = _ann(r, sr_name, CAP_IN)
    carry = (r.integers(0, 1000, CAP_IN).astype(np.int32),
             r.integers(-5, 5, CAP_IN).astype(np.int32))
    return atoms, leaf, ann, carry


def _run_both(seed, sr_name, n_probes, with_anns, hub=False):
    atoms, leaf, ann, carry = _inputs(seed, sr_name, n_probes, with_anns,
                                      hub)
    import jax.numpy as jnp

    def jax_side(morsel=MORSEL):
        j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
        trip = [tuple(j(x) for x in a) for a in atoms]
        return jax_backend._fold_body(
            jnp.asarray(COUNT, jnp.int32), trip[0], tuple(trip[1:]),
            j(ann), tuple(j(x) for x in leaf), tuple(j(c) for c in carry),
            cap_in=CAP_IN, morsel=morsel, sr=jS.BY_NAME[sr_name])

    def torch_side():
        t = lambda x: None if x is None else torch.as_tensor(x)  # noqa: E731
        trip = [tuple(t(x) for x in a) for a in atoms]
        return torch_backend._fold_body(
            torch.tensor(COUNT, dtype=torch.int32), trip[0], tuple(trip[1:]),
            t(ann), tuple(t(x) for x in leaf), tuple(t(c) for c in carry),
            cap_in=CAP_IN, morsel=MORSEL, sr=tS.BY_NAME[sr_name])

    want, got = jax_side(), torch_side()
    (w_count, w_chunks, w_ann, w_carry) = want
    (g_count, g_chunks, g_ann, g_carry) = got
    assert int(g_count) == int(w_count)
    assert int(g_chunks) == int(w_chunks)
    g_ann, w_ann = g_ann.numpy(), np.asarray(w_ann)
    if sr_name == "boolean" and any(x is not None for x in leaf):
        one_chunk = jax_side(morsel=1 << 20)
        assert int(one_chunk[1]) == 1 and int(one_chunk[0]) == int(w_count)
        chunked, w_ann = w_ann, np.asarray(one_chunk[2])
        assert not (w_ann & ~chunked).any()   # only False -> True flips
    assert g_ann.dtype == w_ann.dtype
    if sr_name == "sum_f32":
        np.testing.assert_allclose(g_ann, w_ann, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(g_ann, w_ann)
    assert len(g_carry) == len(w_carry) == 2
    for g, w in zip(g_carry, w_carry):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return int(w_count)


@pytest.mark.parametrize("with_anns", [False, True])
@pytest.mark.parametrize("n_probes", [0, 1, 2])
@pytest.mark.parametrize("sr_name", SEMIRINGS)
def test_fold_body_matches_reference(sr_name, n_probes, with_anns):
    seed = 100 * SEMIRINGS.index(sr_name) + 10 * n_probes + with_anns
    live = _run_both(seed, sr_name, n_probes, with_anns)
    assert 0 < live <= COUNT


@pytest.mark.parametrize("sr_name", SEMIRINGS)
def test_fold_body_hub_row_matches_reference(sr_name):
    """Every seventh row's seed segment is a 3,000-value hub: many morsel
    chunks for one row in the reference's loop."""
    _run_both(7 + SEMIRINGS.index(sr_name), sr_name, 2, True, hub=True)
