"""The int8 paged KV pool in the port against the JAX package: the plain
int8 attention versions against the Pallas kernels (interpret mode) and
the JAX oracles, the write-time quantizers (token scatter and prefill
insert, bit-equal), int8 decode and verify steps, pool accounting, and
the int8 engine's tokens against the golden fixture and the JAX engine.

Tolerances: float32 on the CPU, 2e-5 for attention outputs and 1e-4 for
logits (sums run in other orders); with bf16 queries 2e-2.  int8 codes
and scales are compared bit for bit.  The int8 engine is held to the
fixture's greedy tokens at the reference's own floor, a match rate of
0.90 (``tests/test_kv_quant.py`` MATCH_FLOOR).
"""
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_kernels import _both, _err, _paged_layout, _rand
from repro.configs import get_config, scaled_down
from repro.kernels.paged_attention.kernel import (
    paged_decode_attention_int8 as pallas_decode_int8,
    paged_verify_attention_int8 as pallas_verify_int8)
from repro.kernels.paged_attention.ref import (
    paged_decode_int8_ref as jax_decode_int8_ref,
    paged_verify_int8_ref as jax_verify_int8_ref)
from repro.models import attention as jax_attn
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving.kvcache import PagedCacheSlots as JSlots
from repro.serving.scheduler import SchedulerConfig as JSched
import repro_torch.configs as TC
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import (paged_decode_int8_ref,
                                                     paged_verify_int8_ref)
from repro_torch.models import model as TM
from repro_torch.models.attention import quantized_scatter_token
from repro_torch.models.param import from_numpy_tree
from repro_torch.serving.engine import InferenceEngine, Request
from repro_torch.serving.kvcache import PagedCacheSlots
from repro_torch.serving.scheduler import SchedulerConfig

torch.set_num_threads(1)

GOLDEN = json.loads((Path(__file__).parent / "golden" /
                     "golden_tokens.json").read_text())
MATCH_FLOOR = 0.90


def _cfgs():
    return (scaled_down(get_config("qwen1.5-4b")),
            TC.scaled_down(TC.get_config("qwen1.5-4b")))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp = JM.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, tcfg, jp, from_numpy_tree(jax.tree.map(np.asarray, jp),
                                           "cpu")


def _quantize_pool(kp, vp):
    """Symmetric per-block-per-head int8 quantization of a f32 pool."""
    out = []
    for p in (kp, vp):
        s = (np.abs(p).max(axis=(1, 3)) / 127.0).astype(np.float32)
        q = np.clip(np.round(p / np.maximum(s, 1e-12)[:, None, :, None]),
                    -127, 127).astype(np.int8)
        out += [q, s]
    kq, ks, vq, vs = out
    return kq, vq, ks, vs


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


# ------------------------------------------------------- plain versions
@pytest.mark.parametrize("B,KV,G,W,bs,D", [
    (2, 2, 2, 4, 16, 64),
    (3, 1, 8, 3, 32, 32),     # MQA-style wide groups
    (2, 2, 1, 2, 64, 16),     # MHA (G=1)
])
def test_paged_int8_ref_matches_pallas(B, KV, G, W, bs, D):
    """Int8 decode: the port's plain version against the fused-dequant
    Pallas kernel and the JAX ref, on permuted tables and ragged
    lengths."""
    H, S = KV * G, W * bs
    q = _rand(51, (B, H, D))
    k = _rand(52, (B, S, KV, D))
    v = _rand(53, (B, S, KV, D))
    lens = [S, max(1, S - bs // 2 - 1), 1][:B]
    lengths = np.asarray(lens, np.int32)
    kp, vp, bt = _paged_layout(k, v, bs, seed=B + 7, extra_blocks=5)
    kq, vq, ks, vs = _quantize_pool(kp, vp)
    got = paged_decode_int8_ref(*_t(q[:, None], kq, vq, ks, vs, bt,
                                    lengths))[:, 0]
    args = [jnp.asarray(a) for a in (q, kq, vq, ks, vs, bt, lengths)]
    assert _err(got, pallas_decode_int8(*args, interpret=True)) < 2e-5
    assert _err(got, jax_decode_int8_ref(*args)) < 2e-5


def test_paged_int8_table_permutation_invariant():
    B, KV, G, W, bs, D = 2, 2, 3, 4, 16, 32
    H, S = KV * G, W * bs
    q = _rand(61, (B, 1, H, D))
    k = _rand(62, (B, S, KV, D))
    v = _rand(63, (B, S, KV, D))
    lengths = np.asarray([S - 3, S // 2 + 1], np.int32)
    out = []
    for shuffle in (False, True):
        kp, vp, bt = _paged_layout(k, v, bs, seed=9, extra_blocks=9,
                                   shuffle=shuffle)
        kq, vq, ks, vs = _quantize_pool(kp, vp)
        out.append(paged_decode_int8_ref(*_t(q, kq, vq, ks, vs, bt,
                                             lengths)))
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("T", [1, 3, 5])
def test_paged_verify_int8_block_straddling_tail(T):
    """Int8 verify with tails straddling a block boundary (length % bs <
    T) and one inside the last block, against the Pallas kernel and the
    JAX ref; T == 1 equals the int8 decode version."""
    B, KV, G, W, bs, D = 2, 2, 2, 3, 8, 32
    H, S = KV * G, W * bs
    q = _rand(71, (B, T, H, D))
    k = _rand(72, (B, S, KV, D))
    v = _rand(73, (B, S, KV, D))
    lengths = np.asarray([bs + 2, S - 1], np.int32)
    kp, vp, bt = _paged_layout(k, v, bs, seed=4, extra_blocks=4)
    kq, vq, ks, vs = _quantize_pool(kp, vp)
    got = paged_verify_int8_ref(*_t(q, kq, vq, ks, vs, bt, lengths))
    assert got.shape == (B, T, H, D)
    args = [jnp.asarray(a) for a in (q, kq, vq, ks, vs, bt, lengths)]
    assert _err(got, pallas_verify_int8(*args, interpret=True)) < 2e-5
    assert _err(got, jax_verify_int8_ref(*args)) < 2e-5
    if T == 1:
        dec = paged_decode_int8_ref(*_t(q, kq, vq, ks, vs, bt, lengths))
        assert torch.equal(got, dec)


@pytest.mark.parametrize("qdt,tol", [("f32", 2e-5), ("bf16", 2e-2)])
def test_paged_int8_refs_match_model_oracles(qdt, tol):
    """Against ``models/attention.py paged_{decode,verify}_attention_int8``
    with q in the model's type: q meets the dequantized float32 cache (it
    is never cast to int8).  On CPU tensors the wrappers are the plain
    versions."""
    B, KV, G, W, bs, D, T = 2, 2, 2, 3, 16, 32, 4
    H, S = KV * G, W * bs
    kp, vp, bt = _paged_layout(_rand(82, (B, S, KV, D)),
                               _rand(83, (B, S, KV, D)), bs, seed=5,
                               extra_blocks=2)
    kq, vq, ks, vs = _quantize_pool(kp, vp)
    lengths = np.asarray([S - 2, 21], np.int32)
    rest_j = [jnp.asarray(a) for a in (kq, vq, ks, vs, bt, lengths)]
    rest_t = _t(kq, vq, ks, vs, bt, lengths)
    for n, oracle, ref, wrapper in (
            (1, jax_attn.paged_decode_attention_int8, paged_decode_int8_ref,
             paged_ops.paged_decode_int8),
            (T, jax_attn.paged_verify_attention_int8, paged_verify_int8_ref,
             paged_ops.paged_verify_int8)):
        jq, tq = _both(_rand(81 + n, (B, n, H, D)), qdt)
        got = ref(tq, *rest_t)
        assert got.dtype == torch.float32
        assert _err(got, oracle(jq, *rest_j)) < tol
        assert torch.equal(wrapper(tq, *rest_t), got)


# ------------------------------------------------------------ quantizers
def _scatter_case(seed, widen):
    """An int8 pool leaf with resident codes, and new tokens that either
    exceed (widen) or stay inside (not widen) their blocks' ranges."""
    rng = np.random.default_rng(seed)
    nb, blk, KV, hd, B = 6, 8, 2, 16, 3
    pool = rng.integers(-127, 128, (nb, blk, KV, hd)).astype(np.int8)
    scales = rng.uniform(0.01, 0.05, (nb, KV)).astype(np.float32)
    scales[5] = 0.0                                  # a fresh block
    pb = np.asarray([2, 4, 5], np.int64)
    off = np.asarray([3, 7, 0], np.int64)
    mag = 200.0 if widen else 20.0
    x = (rng.standard_normal((B, KV, hd)) * mag
         * scales[pb][:, :, None]).astype(np.float32)
    if not widen:
        x[2] = 0.0                # a zero token into a zero-scale block
    return pool, scales, x, pb, off


@pytest.mark.parametrize("widen", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantized_scatter_token_bit_equal(widen, dt):
    """Codes and scales bit-equal to ``repro.models.attention.
    quantized_scatter_token`` jitted, as the JAX model runs it.  When the
    new token does not widen the scale, resident codes stay exactly as
    they were (in a block whose scale was 0 they are requantized to 0,
    as in the reference)."""
    pool, scales, x, pb, off = _scatter_case(3 + widen, widen)
    jx, tx = _both(x, dt)
    jpool, jsc = jax.jit(jax_attn.quantized_scatter_token)(
        jnp.asarray(pool), jnp.asarray(scales), jx, jnp.asarray(pb),
        jnp.asarray(off))
    tpool, tsc = torch.from_numpy(pool.copy()), torch.from_numpy(
        scales.copy())
    quantized_scatter_token(tpool, tsc, tx, torch.from_numpy(pb),
                            torch.from_numpy(off))
    assert np.array_equal(tpool.numpy(), np.asarray(jpool))
    assert np.array_equal(tsc.numpy().view(np.int32),
                          np.asarray(jsc).view(np.int32))
    grew = (tsc.numpy()[pb[:2]] > scales[pb[:2]]).any()
    assert grew == widen
    if not widen:
        resident = np.zeros(pool.shape[:2], bool)
        resident[pb[:2]] = True
        resident[pb, off] = False
        assert np.array_equal(tpool.numpy()[resident], pool[resident])
        assert not tpool.numpy()[5].any()     # zero scale: codes reset


def test_int8_insert_prefill_bit_equal():
    """The int8 prefill insert (one scale per (block, KV head) over the
    block's positions and head dims, padding included) against the
    reference ``PagedCacheSlots(kv_dtype="int8").insert_prefill``."""
    jcfg, tcfg = _cfgs()
    L, KV, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    js = JSlots(jcfg, 2, 64, block_size=16, kv_dtype="int8")
    ts = PagedCacheSlots(tcfg, 2, 64, block_size=16, device="cpu",
                         kv_dtype="int8")
    rng = np.random.default_rng(0)
    for S, length in ((32, 21), (32, 32), (64, 40)):
        cache = {n: rng.standard_normal((L, 1, S, KV, hd)).astype(np.float32)
                 for n in ("k", "v")}
        cache["k"][:, :, length:] *= 3.0      # padding sets some scales
        for s in (js, ts):
            slot = s.allocate("x")
            assert s.ensure_capacity(slot, length)
        js.insert_prefill(slot, {"stack": {n: jnp.asarray(a)
                                           for n, a in cache.items()}},
                          length)
        ts.insert_prefill(slot, {"stack": {n: torch.from_numpy(a)
                                           for n, a in cache.items()}},
                          length)
        for n in ("k", "v", "k_scale", "v_scale"):
            got = ts.pool["stack"][n].numpy()
            want = np.asarray(js.pool["stack"][n])
            assert got.dtype == want.dtype and np.array_equal(got, want), n
        for s in (js, ts):
            s.release(slot)


# ----------------------------------------------------------------- model
def _int8_pools(jcfg, seed, nb=12, bs=16):
    L, KV, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    out = {}
    for i, n in enumerate(("k", "v")):
        p = _rand(seed + i, (L, nb, bs, KV, hd), 0.5)
        s = (np.abs(p).max(axis=(2, 4)) / 127.0).astype(np.float32)
        out[n] = np.clip(np.round(p / s[:, :, None, :, None]), -127,
                         127).astype(np.int8)
        out[n + "_scale"] = s
    return out


@pytest.mark.parametrize("T", [1, 4])
def test_int8_decode_and_verify_steps(weights, T):
    """``decode_step_paged`` (T=1) and ``verify_step_paged`` (T=4) over an
    int8 pool against the JAX steps: logits of the live rows within
    1e-4, the codes of the written blocks equal, and their scales equal
    to float32 rounding (the K/V fed to the quantizer come from matmuls
    that sum in other orders, so a block max can differ in its last bit;
    with equal inputs the quantizer is bit-equal, see above).  An inert
    row's writes land in the null block 0, left out."""
    jcfg, tcfg, jp, tp = weights
    pool = _int8_pools(jcfg, 20)
    bt = np.asarray([[3, 7, 1], [5, 2, 0], [0, 0, 0]], np.int32)
    lengths = np.asarray([34, 18, 1], np.int32)      # T=4 tails straddle
    toks = np.asarray([[11, 4, 9, 2], [3, 3, 8, 1], [0, 0, 0, 0]],
                      np.int32)[:, :T]
    jpool = {"stack": {n: jnp.asarray(a) for n, a in pool.items()}}
    tpool = {"stack": {n: torch.from_numpy(a.copy())
                       for n, a in pool.items()}}
    jstep = JM.decode_step_paged if T == 1 else JM.verify_step_paged
    tstep = TM.decode_step_paged if T == 1 else TM.verify_step_paged
    jl, jnew = jstep(jcfg, jp, jnp.asarray(toks), jpool, jnp.asarray(bt),
                     jnp.asarray(lengths))
    tl, tnew = tstep(tcfg, tp, torch.from_numpy(toks), tpool,
                     torch.from_numpy(bt), torch.from_numpy(lengths))
    assert tnew is tpool
    assert _err(tl[:2], jl[:2]) < 1e-4
    for n in ("k", "v"):
        got = tnew["stack"][n][:, 1:].numpy()
        assert np.array_equal(got, np.asarray(jnew["stack"][n])[:, 1:]), n
        assert not np.array_equal(got, pool[n][:, 1:])   # written
        np.testing.assert_allclose(
            tnew["stack"][n + "_scale"][:, 1:].numpy(),
            np.asarray(jnew["stack"][n + "_scale"])[:, 1:], rtol=1e-6,
            atol=0)


def test_int8_step_tracks_bf16_step(weights):
    """One decode step over the int8 pool against the same step over the
    bf16 pool holding the same values: logits within 0.25, argmax equal
    (the reference's ``test_int8_logit_error_bound`` bar)."""
    jcfg, tcfg, _, tp = weights
    pool = _int8_pools(jcfg, 30)
    bt = torch.tensor([[3, 7, 1], [5, 2, 0]], dtype=torch.int32)
    lengths = torch.tensor([34, 18], dtype=torch.int32)
    toks = torch.tensor([[11], [3]], dtype=torch.int32)
    q8 = {"stack": {n: torch.from_numpy(a.copy()) for n, a in pool.items()}}
    bf = {"stack": {n: (q8["stack"][n].float()
                        * q8["stack"][n + "_scale"][:, :, None, :, None]
                        ).to(torch.bfloat16) for n in ("k", "v")}}
    a, _ = TM.decode_step_paged(tcfg, tp, toks, q8, bt, lengths)
    b, _ = TM.decode_step_paged(tcfg, tp, toks, bf, bt, lengths)
    V = tcfg.vocab_size
    assert float((a[:, :V] - b[:, :V]).abs().max()) < 0.25
    assert torch.equal(a[:, :V].argmax(-1), b[:, :V].argmax(-1))


# ----------------------------------------------------------- pool, engine
def test_int8_capacity_doubles_same_budget(weights):
    """At the same pool_tokens budget int8 carries twice the blocks at
    about half the bytes per block (int8 payload plus f32 scales)."""
    _, tcfg, _, tp = weights
    stats = {}
    for dt in ("bf16", "int8"):
        eng = InferenceEngine(tcfg, tp, max_batch=2, capacity=64,
                              pool_tokens=256, kv_dtype=dt, device="cpu")
        assert eng.kv_dtype == dt
        stats[dt] = eng.kv_stats()
    assert stats["int8"]["kv_blocks_total"] == \
        2 * stats["bf16"]["kv_blocks_total"]
    ratio = (stats["int8"]["kv_block_bytes_per_device"]
             / stats["bf16"]["kv_block_bytes_per_device"])
    assert 0.45 < ratio < 0.6


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_kv_stats_match_reference(weights, kv_dtype):
    """``kv_stats()`` has the JAX engine's keys and, for the same pool,
    its values (one device: tp degree 1, per-device bytes = the pool's,
    scale leaves counted)."""
    jcfg, tcfg, jp, tp = weights
    kw = dict(max_batch=2, capacity=64, pool_tokens=128, kv_dtype=kv_dtype)
    want = JE.InferenceEngine(jcfg, jp, **kw).kv_stats()
    got = InferenceEngine(tcfg, tp, device="cpu", **kw).kv_stats()
    assert got == want


def test_kv_dtype_validation(weights):
    _, tcfg, _, tp = weights
    with pytest.raises(ValueError):
        PagedCacheSlots(tcfg, 2, 64, device="cpu", kv_dtype="fp8")
    with pytest.raises(ValueError):
        InferenceEngine(tcfg, tp, kv_dtype="int4", device="cpu")


def _match_rate(got, want):
    hit = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    return hit / max(sum(len(w) for w in want), 1)


@pytest.mark.parametrize("spec", [False, True])
def test_engine_int8_golden_match_rate(spec):
    """int8 KV on the golden ``gqa`` fixture's weights (drawn in jax's
    non-partitionable threefry mode): plain greedy against ``generated``
    and n-gram speculation (spec_k=3) against ``spec_generated``, each at
    the reference's floor of 0.90."""
    g = GOLDEN["gqa"]
    jcfg, tcfg = _cfgs()
    with jax.threefry_partitionable(False):
        jp = JM.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    prompts, want = ((g["spec_prompts"], g["spec_generated"]) if spec
                     else (g["prompts"], g["generated"]))
    kw = {"speculative": "ngram", "spec_k": 3} if spec else {}
    eng = InferenceEngine(tcfg, tp, max_batch=4, capacity=128,
                          kv_dtype="int8", device="cpu", **kw)
    reqs = [Request(prompt=list(p), max_new_tokens=len(w))
            for p, w in zip(prompts, want)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    got = [r.generated for r in reqs]
    assert all(len(a) == len(b) for a, b in zip(got, want))
    assert _match_rate(got, want) >= MATCH_FLOOR


def test_engine_int8_spec_matches_jax_engine(weights):
    """int8 KV with n-gram speculation, chunked prefill and a prefix hit:
    tokens equal the JAX engine's under the same settings."""
    jcfg, tcfg, jp, tp = weights
    rng = np.random.default_rng(11)
    a = rng.integers(1, jcfg.vocab_size, 8).tolist() * 3
    prompts = [a, rng.integers(1, jcfg.vocab_size, 30).tolist(),
               a[:16] + [5, 6, 5, 6]]
    n = [12, 10, 12]
    kw = dict(max_batch=4, capacity=128, kv_dtype="int8",
              speculative="ngram", spec_k=3)
    jeng = JE.InferenceEngine(jcfg, jp, sched=JSched(prefill_chunk=8), **kw)
    teng = InferenceEngine(tcfg, tp, sched=SchedulerConfig(prefill_chunk=8),
                           device="cpu", **kw)
    out = []
    for eng, R in ((jeng, JE.Request), (teng, Request)):
        reqs = [R(prompt=list(p), max_new_tokens=k)
                for p, k in zip(prompts, n)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        out.append([r.generated for r in reqs])
    assert out[0] == out[1]
    assert teng.metrics.requests["engine0-r2"].n_cached == 16
