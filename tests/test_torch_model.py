"""The port's model layers and steps against the JAX package on the same
weights (carried across with ``from_numpy_tree``) and inputs.

Tolerances, float32 on the CPU: 1e-5 for norms, rotary and the MLP,
1e-4 for logits and attention outputs, whose matmuls sum in other
orders.  Cache entries written to the bf16 pool are held to one bf16
step (a float32 value that differs in its last bits can round to the
neighbouring bf16 value).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import TINY_OVERRIDES
from repro.configs import get_config, scaled_down
from repro.models import layers as JL
from repro.models import model as JM
import repro_torch.configs as TC
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.param import from_numpy_tree, tree_items

torch.set_num_threads(1)


def _cfgs(name):
    over = TINY_OVERRIDES if name == "tiny" else {}
    return (scaled_down(get_config("qwen1.5-4b"), **over),
            TC.scaled_down(TC.get_config("qwen1.5-4b"), **over))


@pytest.fixture(scope="module", params=["tiny", "scaled"])
def pair(request):
    """(jax cfg, torch cfg, jax params, torch params) on the same
    float32 weights."""
    jcfg, tcfg = _cfgs(request.param)
    jp = JM.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, tcfg, jp, from_numpy_tree(jax.tree.map(np.asarray, jp),
                                           "cpu")


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _err(got, want) -> float:
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.max(np.abs(g - w)))


# ----------------------------------------------------------------- params
def test_param_tree_paths_match_model_specs(pair):
    jcfg, tcfg, jp, tp = pair
    jspec = jax.tree_util.tree_flatten_with_path(
        JM.model_specs(jcfg), is_leaf=lambda x: hasattr(x, "axes"))[0]
    want = {tuple(k.key for k in path): s.shape for path, s in jspec}
    got = {path: s.shape for path, s in tree_items(TM.model_specs(tcfg))}
    assert got == want
    carried = {path: tuple(t.shape) for path, t in tree_items(tp)}
    assert carried == want
    for path, t in tree_items(tp):
        leaf = jp
        for k in path:
            leaf = leaf[k]
        assert np.array_equal(t.numpy(), np.asarray(leaf))


def test_init_rules_and_device():
    """Port init draws on the given device with the reference's rules
    (ones, zeros, fan_in over prod(shape[:-1]) of the stacked shape)."""
    _, tcfg = _cfgs("tiny")
    p = TM.init(tcfg, seed=3, dtype=torch.float32, device="cpu")
    q = TM.init(tcfg, seed=3, dtype=torch.float32, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_items(p), tree_items(q)))
    assert torch.equal(p["ln_f"]["scale"], torch.ones(tcfg.d_model))
    assert not p["stack"]["mixer"]["bq"].any()
    wq = p["stack"]["mixer"]["wq"]                 # (L, d, H*hd)
    std = 1.0 / np.sqrt(wq.shape[0] * wq.shape[1])
    assert abs(float(wq.std()) / std - 1.0) < 0.1
    assert p["embed"]["embed"].dtype == torch.float32


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("dt,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_apply_norm(pair, dt, tol):
    jcfg, tcfg, jp, tp = pair
    x = _rand(1, (2, 5, jcfg.d_model), 3.0)
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if dt == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    got = TL.apply_norm(
        tcfg, {"scale": tp["stack"]["ln1"]["scale"][0].to(tx.dtype)}, tx)
    want = JL.apply_norm(jcfg, {"scale": jp["stack"]["ln1"]["scale"][0]
                                .astype(jx.dtype)}, jx)
    assert got.dtype == tx.dtype
    assert _err(got, want) < tol


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope(fraction):
    jcfg, tcfg = _cfgs("scaled")
    jcfg = dataclasses.replace(jcfg, rope_fraction=fraction)
    tcfg = dataclasses.replace(tcfg, rope_fraction=fraction)
    x = _rand(2, (2, 7, 3, 32))
    pos = np.random.default_rng(3).integers(0, 4000, (2, 7)).astype(np.int32)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tcfg)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    # positions up to 4000: angles are large, so sin/cos differ in ulps
    assert _err(got, want) < 1e-4
    if fraction < 1.0:            # the unrotated tail passes through
        assert torch.equal(got[..., 16:], torch.from_numpy(x)[..., 16:])


def test_apply_mlp_embed_unembed(pair):
    jcfg, tcfg, jp, tp = pair
    x = _rand(4, (2, 3, jcfg.d_model))
    got = TL.apply_mlp(tcfg, {k: v[0] for k, v in tp["stack"]["mlp"].items()},
                       torch.from_numpy(x))
    want = JL.apply_mlp(jcfg, jax.tree.map(lambda a: a[0],
                                           jp["stack"]["mlp"]),
                        jnp.asarray(x))
    assert _err(got, want) < 1e-5
    # ids past the table are clamped, as mode="clip"
    ids = np.asarray([[0, 5, jcfg.vocab_padded + 7, -3]], np.int32)
    assert _err(TL.embed_tokens(tcfg, tp["embed"], torch.from_numpy(ids)),
                JL.embed_tokens(jcfg, jp["embed"], jnp.asarray(ids))) == 0.0
    logits = TL.unembed(tcfg, tp["embed"], torch.from_numpy(x))
    assert _err(logits, JL.unembed(jcfg, jp["embed"], jnp.asarray(x))) < 1e-4
    if jcfg.vocab_padded != jcfg.vocab_size:
        assert bool((logits[..., jcfg.vocab_size:] == -1e30).all())


# ----------------------------------------------------------------- steps
def _prefill_batch(cfg, B=2, S=32):
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, (B, S))
    lens = np.asarray([S, S - 11][:B], np.int32)
    return toks.astype(np.int32), lens


def test_prefill_logits_and_cache(pair):
    jcfg, tcfg, jp, tp = pair
    toks, lens = _prefill_batch(jcfg)
    jl, jc, _ = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks),
                                      "prompt_lengths": jnp.asarray(lens)})
    tl, tc, aux = TM.prefill(tcfg, tp, {
        "tokens": torch.from_numpy(toks),
        "prompt_lengths": torch.from_numpy(lens)})
    assert tl.dtype == torch.float32 and aux == 0.0
    assert _err(tl, jl) < 1e-4
    for name in ("k", "v"):
        assert _err(tc["stack"][name], jc["stack"][name]) < 1e-4


def test_decode_step_paged_logits_and_pool(pair):
    """One paged decode step: live rows at lengths off the block size and
    an inert row (length 1, null table row).  The port writes the pool in
    place; the reference returns the updated pool."""
    jcfg, tcfg, jp, tp = pair
    L, KV, hd, bs, nb = (jcfg.num_layers, jcfg.num_kv_heads,
                         jcfg.head_dim, 16, 12)
    pool = {n: (_rand(10 + i, (L, nb, bs, KV, hd)) * 0.5)
            for i, n in enumerate(("k", "v"))}
    bt = np.asarray([[3, 7, 1], [5, 0, 0], [0, 0, 0]], np.int32)
    lengths = np.asarray([40, 9, 1], np.int32)
    toks = np.asarray([[11], [3], [0]], np.int32)
    jpool = {"stack": {n: jnp.asarray(a).astype(jnp.bfloat16)
                       for n, a in pool.items()}}
    tpool = {"stack": {n: torch.from_numpy(a).to(torch.bfloat16)
                       for n, a in pool.items()}}
    jl, jnew = JM.decode_step_paged(jcfg, jp, jnp.asarray(toks), jpool,
                                    jnp.asarray(bt), jnp.asarray(lengths))
    tl, tnew = TM.decode_step_paged(tcfg, tp, torch.from_numpy(toks), tpool,
                                    torch.from_numpy(bt),
                                    torch.from_numpy(lengths))
    assert tnew is tpool                   # updated in place
    assert _err(tl[:2], jl[:2]) < 1e-4     # row 2 is inert
    for n in ("k", "v"):
        got = tnew["stack"][n][:, 1:].float().numpy()   # block 0 is null
        want = np.asarray(jnew["stack"][n][:, 1:].astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-3)
        written = got != pool[n][:, 1:].astype(np.float32)
        assert written.any()


def test_plain_kernel_set_is_the_cpu_path(pair):
    """``PLAIN`` (used on the card to hold the kernels to account) and
    the default kernel set give the same bits on CPU tensors."""
    from repro_torch.kernels import PLAIN
    jcfg, tcfg, jp, tp = pair
    toks, lens = _prefill_batch(jcfg, B=1, S=32)
    batch = {"tokens": torch.from_numpy(toks),
             "prompt_lengths": torch.from_numpy(lens[:1])}
    a, ca, _ = TM.prefill(tcfg, tp, batch)
    b, cb, _ = TM.prefill(tcfg, tp, batch, kernels=PLAIN)
    assert torch.equal(a, b) and torch.equal(ca["stack"]["k"],
                                             cb["stack"]["k"])


def test_unported_configs_refused():
    cfg = TC.scaled_down(TC.get_config("qwen1.5-4b"), norm="layernorm")
    with pytest.raises(NotImplementedError):
        TM.model_specs(cfg)
    assert TM.supports_paged_cache(TC.get_config("qwen1.5-4b"))
