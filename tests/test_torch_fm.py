"""The port's FM serving path against the JAX package on the CPU: the
``fm_interaction`` wrapper (plain version) against the reference's Pallas
kernel in interpret mode and both of its refs, within 1e-5 of each row's
absolute scale (the sum-square form cancels, so the result may lie near
0); ``forward``, ``loss_fn``, ``retrieval_scores``, ``embedding_bag``
and ``batched_scores`` against the reference at ``rtol=1e-5, atol=1e-6``,
NaN in the same places for out-of-range ids; ``RecsysBatchGen``, the
config and the shapes equal to the reference's.  Inputs and weights come
from a numpy seed and cross through ``params_from_reference``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import fm as jax_fm_config
from repro.data.recsys import RecsysBatchGen as JaxBatchGen
from repro.kernels.fm_interaction.ops import fm_interaction as jax_fm_kernel
from repro.kernels.fm_interaction.ref import (
    fm_interaction_pairwise_ref as jax_pairwise, fm_interaction_ref as jax_ref)
from repro.models.recsys import fm as jfm
from repro.serve.engine import batched_scores as jax_batched_scores
from repro_torch.configs import REGISTRY, base, get_arch
from repro_torch.configs import fm as fm_config
from repro_torch.data import RecsysBatchGen
from repro_torch.kernels import common, fm_interaction
from repro_torch.kernels.fm_interaction.ref import (
    fm_interaction_pairwise_ref, fm_interaction_ref, fm_interaction_scale)
from repro_torch.models.recsys import fm
from repro_torch.serve import batched_scores

# kernel against a plain version: the same sums in another order, per row
# within this share of the terms the sum-square form cancels
SCALE_REL = 1e-5
RTOL, ATOL = 1e-5, 1e-6
SWEEP = [(1, 2, 4), (33, 39, 10), (128, 16, 32), (7, 8, 8), (0, 3, 4)]
SIZES = [(5, 50, 8), (39, 100, 10)]   # (F, V, D)


def _emb(b, f, d, seed=0):
    return np.random.default_rng(seed).normal(size=(b, f, d)) \
        .astype(np.float32)


def assert_within_scale(got, want, emb):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape == (emb.shape[0],)
    scale = fm_interaction_scale(torch.as_tensor(emb, dtype=torch.float64))
    assert np.all(np.abs(got - want) <= SCALE_REL * scale.numpy())


def _configs(f, v, d, **kw):
    return (fm.FMConfig(name="t", n_sparse=f, vocab_per_field=v,
                        embed_dim=d),
            jfm.FMConfig(name="t", n_sparse=f, vocab_per_field=v,
                         embed_dim=d, **kw))


def _weights(cfg, seed=0):
    r = np.random.default_rng(seed)
    return {"emb": (r.normal(size=(cfg.total_rows, cfg.embed_dim)) * 0.01)
            .astype(np.float32),
            "w_lin": (r.normal(size=cfg.total_rows) * 0.01)
            .astype(np.float32),
            "w0": np.float32(r.normal() * 0.1)}


def _both(f, v, d, seed=0, **kw):
    cfg, jcfg = _configs(f, v, d, **kw)
    w = _weights(cfg, seed)
    return (cfg, fm.params_from_reference(w, device="cpu"), jcfg,
            {k: jnp.asarray(x) for k, x in w.items()})


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# -------------------------------------------------------------- the kernel
@pytest.mark.parametrize("b,f,d", SWEEP)
def test_fm_interaction_matches_reference(b, f, d):
    emb = _emb(b, f, d)
    before = dict(common.LAUNCHES)
    got = fm_interaction(torch.as_tensor(emb))
    assert dict(common.LAUNCHES) == before     # the CPU path launches none
    assert got.dtype == torch.float32 and got.shape == (b,)
    e = jnp.asarray(emb)
    for want in (jax_fm_kernel(emb, interpret=True), jax_ref(e),
                 jax_pairwise(e)):
        assert np.asarray(want).shape == (b,)
        assert_within_scale(got.numpy(), want, emb)
    # the port's refs against the reference's, formulation by formulation
    t = torch.as_tensor(emb)
    assert_within_scale(fm_interaction_ref(t).numpy(), jax_ref(e), emb)
    assert_within_scale(fm_interaction_pairwise_ref(t).numpy(),
                        jax_pairwise(e), emb)


def test_fm_interaction_wrapper_casts_and_checks():
    emb = _emb(9, 6, 5, seed=3)
    want = fm_interaction(torch.as_tensor(emb))
    # float64 is cast to float32, as the reference's ops cast it
    got = fm_interaction(torch.as_tensor(emb, dtype=torch.float64))
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    # a non-contiguous input is made contiguous
    t = torch.as_tensor(np.ascontiguousarray(emb.transpose(0, 2, 1))) \
        .transpose(1, 2)
    assert not t.is_contiguous()
    assert torch.equal(fm_interaction(t), want)
    with pytest.raises(ValueError, match="rank"):
        fm_interaction(torch.zeros(4, 5))
    with pytest.raises(ValueError, match="F >= 1"):
        fm_interaction(torch.zeros(4, 0, 5))
    with pytest.raises(TypeError):
        fm_interaction(emb)


def test_fm_interaction_cpu_path_is_differentiable():
    emb = _emb(4, 5, 3, seed=1).astype(np.float64)
    t = torch.as_tensor(emb, dtype=torch.float32).requires_grad_(True)
    fm_interaction(t).sum().backward()
    # d/de[b,f,d] = sum_g e[b,g,d] - e[b,f,d]
    want = emb.sum(axis=1, keepdims=True) - emb
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("f,v,d", SIZES)
def test_forward_matches_reference(f, v, d, use_kernel):
    cfg, params, jcfg, jparams = _both(f, v, d, use_kernel=use_kernel)
    batch = RecsysBatchGen(f, v, 70, seed=f).batch_at(3)
    got = fm.forward(params, batch, cfg)
    assert got.dtype == torch.float32 and got.shape == (70,)
    _close(got, jfm.forward(jparams, batch, jcfg))


@pytest.mark.parametrize("f,v,d", SIZES)
def test_loss_fn_matches_reference(f, v, d):
    cfg, params, jcfg, jparams = _both(f, v, d, seed=2)
    batch = RecsysBatchGen(f, v, 64, seed=1).batch_at(0)
    loss, aux = fm.loss_fn(params, batch, cfg)
    jloss, jaux = jfm.loss_fn(jparams, batch, jcfg)
    _close(loss, jloss)
    _close(aux["bce"], jaux["bce"])


def test_loss_gradient_matches_reference_on_cpu():
    cfg, params, jcfg, jparams = _both(5, 50, 8, seed=4)
    batch = RecsysBatchGen(5, 50, 32, seed=2).batch_at(1)
    params = {k: p.requires_grad_(True) for k, p in params.items()}
    fm.loss_fn(params, batch, cfg)[0].backward()
    want = jax.grad(lambda p: jfm.loss_fn(p, batch, jcfg)[0])(jparams)
    for k in ("emb", "w_lin", "w0"):
        np.testing.assert_allclose(params[k].grad.numpy(), want[k],
                                   rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("f,v,d", SIZES)
def test_retrieval_scores_match_reference(f, v, d):
    cfg, params, jcfg, jparams = _both(f, v, d, seed=5)
    r = np.random.default_rng(f)
    users = r.integers(0, cfg.total_rows, 16).astype(np.int32)
    cands = r.integers(0, cfg.total_rows, 300).astype(np.int32)
    got = fm.retrieval_scores(params, users, cands, cfg)
    assert got.shape == (300,)
    _close(got, jfm.retrieval_scores(jparams, users, cands, jcfg))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_matches_reference(combiner):
    cfg, params, _, jparams = _both(5, 50, 8, seed=6)
    r = np.random.default_rng(7)
    ids = r.integers(0, cfg.total_rows, 200).astype(np.int32)
    segs = np.sort(r.integers(0, 40, 200)).astype(np.int32)  # some empty
    got = fm.embedding_bag(params["emb"], ids, segs, 40, combiner)
    want = jfm.embedding_bag(jparams["emb"], jnp.asarray(ids),
                             jnp.asarray(segs), 40, combiner)
    assert got.shape == (40, 8)
    _close(got, want)


def test_batched_scores_match_reference():
    cfg, params, jcfg, jparams = _both(39, 100, 10, seed=8)
    ids = RecsysBatchGen(39, 100, 100, seed=3).batch_at(0)["ids"]
    got = batched_scores(lambda c: fm.forward(params, c, cfg),
                         {"ids": ids}, 32)
    want = jax_batched_scores(lambda c: jfm.forward(jparams, c, jcfg),
                              {"ids": ids}, 32)
    assert isinstance(got, np.ndarray) and got.shape == (100,)
    _close(got, want)
    np.testing.assert_array_equal(
        got, fm.forward(params, {"ids": ids}, cfg).numpy())


# ------------------------------------------------------- out-of-range ids
def _nan_parity(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    _close(got[~np.isnan(got)], want[~np.isnan(want)])


def test_forward_out_of_range_ids_match_reference():
    f, v = 5, 50
    cfg, params, jcfg, jparams = _both(f, v, 8, seed=10)
    rows = f * v
    ids = RecsysBatchGen(f, v, 12, seed=4).batch_at(0)["ids"].copy()
    ids[1, 0] = v + 3              # lands in field 1's range: finite
    ids[2, 0] = -1                 # global row -1 wraps to the last row
    ids[3, 0] = -rows              # wraps to row 0
    ids[4, 0] = -rows - 1          # below -rows: NaN
    ids[5, f - 1] = v              # global row == rows: NaN
    ids[6, 2] = 10 ** 9            # far past the table: NaN
    ids[7, 3] = -(10 ** 9)
    got = fm.forward(params, {"ids": ids}, cfg)
    want = jfm.forward(jparams, {"ids": ids}, jcfg)
    assert np.isnan(np.asarray(want)).tolist() == \
        [False] * 4 + [True] * 4 + [False] * 4
    _nan_parity(got, want)


def test_retrieval_and_bag_out_of_range_ids_match_reference():
    cfg, params, jcfg, jparams = _both(5, 50, 8, seed=11)
    rows = cfg.total_rows
    cands = np.array([0, rows - 1, rows, -1, -rows, -rows - 1, 7], np.int32)
    for users in (np.array([3, -2, 9], np.int32),
                  np.array([3, rows, 9], np.int32)):
        _nan_parity(fm.retrieval_scores(params, users, cands, cfg),
                    jfm.retrieval_scores(jparams, users, cands, jcfg))
    ids = np.array([0, 1, rows, -1, -rows - 1, 5, rows + 4], np.int32)
    segs = np.array([0, 0, 1, 2, -1, 3, 9], np.int32)   # -1, 9: dropped
    for combiner in ("sum", "mean"):
        got = fm.embedding_bag(params["emb"], ids, segs, 4, combiner)
        want = jfm.embedding_bag(jparams["emb"], jnp.asarray(ids),
                                 jnp.asarray(segs), 4, combiner)
        _nan_parity(got, want)


# ------------------------------------------------- data, configs and init
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 1), (7, 123)])
def test_batch_gen_matches_reference(seed, step):
    got = RecsysBatchGen(39, 1000, 257, seed=seed).batch_at(step)
    want = JaxBatchGen(39, 1000, 257, seed=seed).batch_at(step)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_config_and_shapes_match_reference():
    got, want = fm_config.CONFIG, jax_fm_config.CONFIG
    for field in dataclasses.fields(got):
        if field.name != "dtype":
            assert getattr(got, field.name) == getattr(want, field.name)
    assert got.dtype == torch.float32
    assert (got.total_rows, got.param_count()) == \
        (want.total_rows, want.param_count()) == (39_000_000, 429_000_001)
    assert base.recsys_shapes() == {
        k: base.ShapeDef(s.name, s.kind, s.params, s.skip)
        for k, s in jax_base.recsys_shapes().items()}
    arch, jarch = get_arch("fm"), jax_fm_config.ARCH
    assert list(REGISTRY) == ["fm"] and arch is fm_config.ARCH
    for k in ("name", "family", "tag", "source"):
        assert getattr(arch, k) == getattr(jarch, k)
    assert arch.config is fm_config.CONFIG
    assert arch.shape("serve_bulk").params == {"batch": 262144}
    assert fm.param_axes(got) == jfm.param_axes(want)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("qwen2-72b")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_on_cpu(dtype):
    cfg = dataclasses.replace(fm.FMConfig(name="t", n_sparse=6,
                                          vocab_per_field=2000,
                                          embed_dim=10), dtype=dtype)
    p = fm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["emb"].shape == (12_000, 10) and p["w_lin"].shape == (12_000,)
    assert p["w0"].shape == () and float(p["w0"]) == 0.0
    for k in ("emb", "w_lin", "w0"):
        assert p[k].dtype == dtype and p[k].device.type == "cpu"
    for k in ("emb", "w_lin"):
        x = p[k].float()
        assert abs(float(x.std()) - 0.01) < 5e-4
        assert abs(float(x.mean())) < 5e-4
    again = fm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["emb"], p["emb"])
    with pytest.raises(ValueError, match="generator"):
        fm.init(cfg, torch.Generator(), device="meta")


def test_serving_entry_points_need_a_card(monkeypatch):
    """With no device named, ``init`` and ``params_from_reference`` go to
    ``cuda`` and raise without a card; the CPU is taken when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = fm.FMConfig(name="t", n_sparse=2, vocab_per_field=5, embed_dim=3)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        fm.init(cfg, torch.Generator())
    w = _weights(cfg)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        fm.params_from_reference(w)
    assert fm.params_from_reference(w, device="cpu")["emb"].device.type \
        == "cpu"
