"""Speculative decoding in the port against the JAX package: the plain
paged-verify version against the Pallas kernel (interpret mode) and the
JAX oracles, ``verify_step_paged`` logits, the greedy accept cascade, the
n-gram drafter, and the speculative engine's tokens against the golden
fixture, the JAX engine and the port's own plain engine.

Tolerances: float32 on the CPU, 2e-5 for attention outputs and 1e-4 for
logits (sums run in other orders); bf16 outputs within 2e-2 (one bf16
step).  Greedy tokens are compared exactly.
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
from repro.kernels.paged_attention.kernel import \
    paged_verify_attention as pallas_verify
from repro.kernels.paged_attention.ref import \
    paged_verify_ref as jax_verify_ref
from repro.models import attention as jax_attn
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving.kvcache import PagedCacheSlots as JSlots
from repro.serving.sampling import spec_accept_batched as jax_accept
from repro.serving.scheduler import SchedulerConfig as JSched
from repro.serving.speculative import NGramDrafter as JNGram
import repro_torch.configs as TC
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import (paged_decode_ref,
                                                     paged_verify_ref)
from repro_torch.models import model as TM
from repro_torch.models.param import from_numpy_tree
from repro_torch.serving.engine import InferenceEngine, Request
from repro_torch.serving.kvcache import PagedCacheSlots
from repro_torch.serving.metrics import MetricsCollector
from repro_torch.serving.sampling import spec_accept_batched
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.speculative import NGramDrafter, make_drafter

torch.set_num_threads(1)

GOLDEN = json.loads((Path(__file__).parent / "golden" /
                     "golden_tokens.json").read_text())


def _cfgs():
    return (scaled_down(get_config("qwen1.5-4b")),
            TC.scaled_down(TC.get_config("qwen1.5-4b")))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp = JM.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, tcfg, jp, from_numpy_tree(jax.tree.map(np.asarray, jp),
                                           "cpu")


# ------------------------------------------------------- verify plain version
def _verify_port(q, kp, vp, bt, lengths):
    return paged_verify_ref(*(torch.from_numpy(np.asarray(a))
                              for a in (q, kp, vp, bt, lengths)))


@pytest.mark.parametrize("B,KV,G,W,bs,D,T", [
    (2, 2, 2, 4, 16, 64, 4),
    (3, 1, 8, 3, 32, 32, 3),      # MQA-style wide groups
    (1, 2, 2, 4, 8, 32, 5),       # tail spans a block boundary
    (2, 2, 1, 2, 64, 16, 1),      # T=1: the single-query case
    (3, 4, 1, 4, 16, 32, 5),      # G=1 as qwen1.5-4b, tails straddling
])
def test_paged_verify_ref_matches_pallas(B, KV, G, W, bs, D, T):
    """The port's plain verify against the Pallas kernel (interpret
    mode) and the JAX ref on permuted tables; T == 1 equals the plain
    decode version."""
    H, S = KV * G, W * bs
    q = _rand(B * 100 + T, (B, T, H, D))
    k = _rand(2, (B, S, KV, D))
    v = _rand(3, (B, S, KV, D))
    lens = [S, max(T + 1, S - bs // 2 - 1), max(T, S // 2)][:B]
    if T == 5 and bs == 16:
        lens = [bs + 2, 2 * bs + 1, S - 3][:B]   # len % bs < T
    lengths = np.asarray(lens + [S] * (B - len(lens)), np.int32)[:B]
    kp, vp, bt = _paged_layout(k, v, bs, seed=B, extra_blocks=3)
    got = _verify_port(q, kp, vp, bt, lengths)
    assert got.shape == (B, T, H, D) and got.dtype == torch.float32
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, lengths)]
    assert _err(got, pallas_verify(*args, interpret=True)) < 2e-5
    assert _err(got, jax_verify_ref(*args)) < 2e-5
    if T == 1:
        dec = paged_decode_ref(*(torch.from_numpy(a)
                                 for a in (q, kp, vp, bt, lengths)))
        assert torch.equal(got, dec)


@pytest.mark.parametrize("dt,tol", [("f32", 2e-5), ("bf16", 2e-2)])
def test_paged_verify_ref_matches_model_oracle(dt, tol):
    """Against ``models/attention.py paged_verify_attention`` (q cast to
    the pool type, p rounded to it before PV), with an inert row (length
    1, null table row) whose output both sides discard."""
    B, KV, G, W, bs, D, T = 3, 2, 2, 3, 16, 32, 4
    H, S = KV * G, W * bs
    kp, vp, bt = _paged_layout(_rand(32, (B, S, KV, D)),
                               _rand(33, (B, S, KV, D)), bs, seed=4,
                               extra_blocks=2)
    bt[2] = 0
    q = _rand(31, (B, T, H, D))
    lengths = np.asarray([S - 1, 18, 1], np.int32)
    jq, tq = _both(q)
    jk, tk = _both(kp, dt)
    jv, tv = _both(vp, dt)
    got = paged_verify_ref(tq, tk, tv, torch.from_numpy(bt),
                           torch.from_numpy(lengths))
    want = jax_attn.paged_verify_attention(jq, jk, jv, jnp.asarray(bt),
                                           jnp.asarray(lengths))
    assert _err(got[:2], want[:2]) < tol
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(paged_ops.paged_verify(tq, tk, tv,
                                              torch.from_numpy(bt),
                                              torch.from_numpy(lengths)),
                       got)


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("pool_dt", ["bf16", "f32"])
def test_verify_step_paged_logits_and_pool(weights, pool_dt):
    """One verify step of T=4: live rows whose tails straddle a block and
    an inert row (length 1, null table row, negative tail positions).
    Logits against the JAX ``verify_step_paged``; the pool is written in
    place at the same positions."""
    jcfg, tcfg, jp, tp = weights
    L, KV, hd, bs, nb, T = (jcfg.num_layers, jcfg.num_kv_heads,
                            jcfg.head_dim, 16, 12, 4)
    pool = {n: _rand(10 + i, (L, nb, bs, KV, hd), 0.5)
            for i, n in enumerate(("k", "v"))}
    bt = np.asarray([[3, 7, 1], [5, 2, 0], [0, 0, 0]], np.int32)
    lengths = np.asarray([34, 18, 1], np.int32)      # tails 30..33, 14..17
    toks = np.asarray([[11, 4, 9, 2], [3, 3, 8, 1], [0, 0, 0, 0]], np.int32)
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[pool_dt]
    jpool = {"stack": {n: jnp.asarray(a).astype(jdt)
                       for n, a in pool.items()}}
    tpool = {"stack": {n: torch.from_numpy(a).to(tdt)
                       for n, a in pool.items()}}
    jl, jnew = JM.verify_step_paged(jcfg, jp, jnp.asarray(toks), jpool,
                                    jnp.asarray(bt), jnp.asarray(lengths))
    tl, tnew = TM.verify_step_paged(tcfg, tp, torch.from_numpy(toks), tpool,
                                    torch.from_numpy(bt),
                                    torch.from_numpy(lengths))
    assert tnew is tpool and tl.shape == (3, T, jcfg.vocab_padded)
    assert _err(tl[:2], jl[:2]) < 1e-4
    for n in ("k", "v"):
        got = tnew["stack"][n][:, 1:].float().numpy()   # block 0 is null
        want = np.asarray(jnew["stack"][n][:, 1:].astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-3)


def test_verify_step_t1_is_decode_step(weights):
    """T == 1 verify is the decode step (same kernels, same bits)."""
    _, tcfg, _, tp = weights
    L, KV, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    pool = _rand(5, (L, 6, 16, KV, hd), 0.5)
    mk = lambda: {"stack": {n: torch.from_numpy(pool).to(torch.bfloat16)
                            for n in ("k", "v")}}
    bt = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    lengths = torch.tensor([20, 7], dtype=torch.int32)
    toks = torch.tensor([[5], [9]], dtype=torch.int32)
    a, _ = TM.verify_step_paged(tcfg, tp, toks, mk(), bt, lengths)
    b, _ = TM.decode_step_paged(tcfg, tp, toks, mk(), bt, lengths)
    assert torch.equal(a[:, 0], b)


# --------------------------------------------------------------- accept
def test_spec_accept_matches_reference():
    """The greedy cascade against the JAX ``spec_accept_batched`` in
    greedy mode, with rows of 0..k real drafts and drafts built to match
    the argmax for a random prefix."""
    B, T, V = 16, 5, 11
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    gm = logits.argmax(-1)
    toks = rng.integers(0, V, (B, T)).astype(np.int32)
    for b in range(B):
        m = rng.integers(0, T)              # drafts equal to argmax first
        toks[b, 1:1 + m] = gm[b, :m]
    nd = rng.integers(0, T, B).astype(np.int32)
    out, ne = spec_accept_batched(torch.from_numpy(logits),
                                  torch.from_numpy(toks),
                                  torch.from_numpy(nd))
    jout, jne = jax_accept(jnp.asarray(logits), jnp.asarray(toks), None,
                           jnp.asarray(nd), jax.random.PRNGKey(0),
                           jnp.zeros((B,)), jnp.zeros((B,), jnp.int32),
                           jnp.ones((B,)), True)
    assert np.array_equal(ne.numpy(), np.asarray(jne))
    assert np.array_equal(out.numpy(), np.asarray(jout))
    # n_draft == 0 rows emit exactly the plain argmax
    zero = nd == 0
    assert (ne.numpy()[zero] == 1).all()
    assert np.array_equal(out.numpy()[zero, 0], gm[zero, 0])


def test_ngram_drafter_matches_reference():
    d, jd = NGramDrafter(64), JNGram(64)
    assert d.deterministic and d.name == "ngram"
    assert d.propose(0, [1, 7, 8, 9, 5, 6, 7, 8, 9], 3, 0.0) == \
        ([5, 6, 7], None)
    assert d.propose(0, [1, 2, 3, 4, 5], 3, 0.0) == ([], None)
    assert d.propose(0, [7, 1, 7, 2, 7], 1, 0.0)[0] == [2]
    rng = np.random.default_rng(1)
    for _ in range(200):
        ctx = rng.integers(0, 6, rng.integers(1, 30)).tolist()
        k = int(rng.integers(1, 6))
        assert d.propose(0, ctx, k, 0.0) == jd.propose(0, ctx, k, 0.0)


def test_drafter_and_engine_validation(weights):
    _, tcfg, _, tp = weights
    assert make_drafter(None, tcfg, spec_k=4, capacity=64) is None
    with pytest.raises(NotImplementedError, match="B7"):
        make_drafter("draft", tcfg, spec_k=4, capacity=64)
    with pytest.raises(ValueError):
        make_drafter("huh", tcfg, spec_k=4, capacity=64)
    with pytest.raises(ValueError):
        InferenceEngine(tcfg, tp, speculative="huh", device="cpu")
    eng = InferenceEngine(tcfg, tp, speculative="ngram", spec_k=3,
                          device="cpu")
    assert isinstance(eng.drafter, NGramDrafter) and eng.spec_k == 3
    with pytest.raises(ValueError):       # greedy only
        eng.submit(Request(prompt=[1, 2], temperature=0.5))


def test_speculative_metrics():
    m = MetricsCollector()
    assert np.isnan(m.summary()["spec_acceptance_rate"])
    assert np.isnan(m.summary()["spec_tokens_per_launch"])
    m.speculative(3, 2, 3)
    m.speculative(0, 0, 1)
    m.speculative(4, 4, 2)          # burst cut by the budget
    s = m.summary()
    assert s["spec_acceptance_rate"] == 6 / 7
    assert s["spec_tokens_per_launch"] == 2.0


# ----------------------------------------------------------------- engine
def _run_port(tcfg, tp, prompts, max_new, capacity=128, **kw):
    eng = InferenceEngine(tcfg, tp, max_batch=4, capacity=capacity,
                          device="cpu", **kw)
    reqs = [Request(prompt=list(p), max_new_tokens=n)
            for p, n in zip(prompts, max_new)]
    for r in reqs:
        eng.submit(r)
    summary = eng.run_until_idle()
    return [r.generated for r in reqs], summary, eng


def test_engine_spec_reproduces_golden_gqa_tokens():
    """n-gram speculation with spec_k=3 on the golden ``gqa`` fixture's
    weights (drawn in jax's non-partitionable threefry mode, in which
    the fixture was written) reproduces ``spec_generated``."""
    g = GOLDEN["gqa"]
    jcfg, tcfg = _cfgs()
    with jax.threefry_partitionable(False):
        jp = JM.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    got, s, eng = _run_port(tcfg, tp, g["spec_prompts"],
                            [len(w) for w in g["spec_generated"]],
                            speculative="ngram", spec_k=3)
    assert got == g["spec_generated"]
    assert eng.scheduler.verify_steps > 0
    assert s["spec_acceptance_rate"] > 0 and s["spec_tokens_per_launch"] > 1


def _spec_prompts(vocab, n=4, reps=3, tail=2, seed=3):
    """Repetitive prompts (pattern * reps + unique tail): the n-gram
    drafter finds suffix matches, so acceptance is exercised for real."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(1, vocab - 1, 6).tolist()
    return [pat * reps + rng.integers(1, vocab - 1, tail).tolist()
            for _ in range(n)]


def _traffic(vocab):
    """Chunked prefill (prompts past a prefill_chunk of 8), a prefix hit
    (the last prompt extends the first's first 16 tokens), and
    repetition for the drafter."""
    rng = np.random.default_rng(7)
    a = rng.integers(1, vocab, 8).tolist() * 3
    return [a,
            rng.integers(1, vocab, 37).tolist(),
            rng.integers(1, vocab, 3).tolist() * 2,
            a[:16] + rng.integers(1, vocab, 6).tolist()]


def test_engine_spec_matches_jax_and_plain_engine(weights):
    """Speculative serving with chunked prefill and a prefix hit: tokens
    equal the port's plain engine and the JAX speculative engine, and
    the acceptance metrics equal the JAX engine's."""
    jcfg, tcfg, jp, tp = weights
    prompts = _traffic(jcfg.vocab_size)
    n = [12, 9, 10, 14]
    plain, _, _ = _run_port(tcfg, tp, prompts, n,
                            sched=SchedulerConfig(prefill_chunk=8))
    spec, s, eng = _run_port(tcfg, tp, prompts, n, speculative="ngram",
                             spec_k=3, sched=SchedulerConfig(prefill_chunk=8))
    assert spec == plain
    assert eng.metrics.requests["engine0-r3"].n_cached == 16
    assert s["spec_acceptance_rate"] > 0
    jeng = JE.InferenceEngine(jcfg, jp, max_batch=4, capacity=128,
                              speculative="ngram", spec_k=3,
                              sched=JSched(prefill_chunk=8))
    jreqs = [JE.Request(prompt=list(p), max_new_tokens=k)
             for p, k in zip(prompts, n)]
    for r in jreqs:
        jeng.submit(r)
    js = jeng.run_until_idle()
    assert [r.generated for r in jreqs] == spec
    for key in ("spec_acceptance_rate", "spec_tokens_per_launch",
                "prefill_tokens_saved"):
        assert s[key] == js[key], key
    # rollback accounting: no leaked blocks once drained (the radix tree
    # holds the only references left)
    assert eng.slots.bp.num_used == eng.scheduler.prefix_cache.n_nodes
    assert not eng.slots.slot_owner


def test_spec_k0_degenerates_to_plain_engine(weights):
    _, tcfg, _, tp = weights
    prompts = _spec_prompts(tcfg.vocab_size, n=3, seed=13)
    base, _, _ = _run_port(tcfg, tp, prompts, [6] * 3)
    spec, s, eng = _run_port(tcfg, tp, prompts, [6] * 3,
                             speculative="ngram", spec_k=0)
    assert spec == base
    assert s["spec_tokens_per_launch"] == 1.0
    assert eng.scheduler.micro_steps == 0 and eng.scheduler.verify_steps > 0


def test_spec_preemption_under_pool_pressure(weights):
    """Speculative growth (+k+1 positions per slot per step) under a small
    pool: preemption and requeue still resume token-exactly, as the plain
    unconstrained run."""
    _, tcfg, _, tp = weights
    prompts = _spec_prompts(tcfg.vocab_size, n=4, seed=19)
    sched = SchedulerConfig(prefix_block=4, prefill_chunk=8)
    base, _, _ = _run_port(tcfg, tp, prompts, [10] * 4, sched=sched)
    # 16 blocks of 4 for four requests of up to 33 positions each
    spec, s, eng = _run_port(tcfg, tp, prompts, [10] * 4, capacity=40,
                             sched=sched, speculative="ngram", spec_k=3,
                             pool_tokens=64)
    assert s["preempted"] > 0
    assert spec == base
    assert not eng.slots.slot_owner


def test_paged_trim_frees_tail_blocks():
    """``trim`` against the reference on the same calls: tail blocks are
    freed and nulled, adopted prefix blocks never."""
    jcfg, tcfg = _cfgs()
    states = []
    for s in (JSlots(jcfg, 2, 64, block_size=8),
              PagedCacheSlots(tcfg, 2, 64, block_size=8, device="cpu")):
        a = s.allocate("r0")
        assert s.ensure_capacity(a, 30)          # 4 blocks
        held = s.block_ids(a)
        s.trim(a, 17)                            # 3 blocks suffice
        assert s.block_ids(a) == held[:3]
        assert held[3] not in s.bp.refs and s.tables[a, 3] == 0
        s.trim(a, 17)                            # idempotent
        assert s.block_ids(a) == held[:3]
        b = s.allocate("r1")
        s.adopt_prefix(b, held[:2], 16)
        s.ensure_capacity(b, 20)
        s.trim(b, 17)
        assert s.bp.refs[held[0]] == 2 and s.bp.refs[held[1]] == 2
        states.append((s.tables.tolist(), dict(s.bp.refs), list(s.bp.free)))
        s.release(a)
        s.release(b)
        assert s.bp.num_used == 0
    assert states[0] == states[1]
