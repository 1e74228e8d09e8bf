"""The port's serving stack against the JAX package: block bookkeeping on
the same call sequences, and the engine's greedy tokens against the JAX
engine (and its golden fixture) on the same weights.

Greedy tokens are compared exactly.  The golden ``gqa`` fixture was
written with weights from ``jax.random`` in its non-partitionable
threefry mode, the default of the jax it was generated with; the test
draws the weights in that mode to reproduce them.
"""
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config, scaled_down
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving.kvcache import PagedCacheSlots as JSlots
from repro.serving.scheduler import SchedulerConfig as JSched
import repro_torch.configs as TC
from repro_torch.models.param import from_numpy_tree
from repro_torch.serving.engine import InferenceEngine, Request
from repro_torch.serving.faults import EngineFailure, EngineTimeout
from repro_torch.serving.kvcache import BlockPool, PagedCacheSlots
from repro_torch.serving.scheduler import SchedulerConfig

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


def _run_port(tcfg, tp, prompts, max_new, **kw):
    eng = InferenceEngine(tcfg, tp, max_batch=4, capacity=128, device="cpu",
                          **kw)
    reqs = [Request(prompt=list(p), max_new_tokens=n)
            for p, n in zip(prompts, max_new)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return [r.generated for r in reqs], eng


def _run_jax(jcfg, jp, prompts, max_new, **kw):
    eng = JE.InferenceEngine(jcfg, jp, max_batch=4, capacity=128, **kw)
    reqs = [JE.Request(prompt=list(p), max_new_tokens=n)
            for p, n in zip(prompts, max_new)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return [r.generated for r in reqs]


# ----------------------------------------------------------------- blocks
def _state(s):
    return (s.tables.tolist(), s.lengths.tolist(),
            {k: list(v) for k, v in s.seq_blocks.items()},
            list(s.bp.free), dict(s.bp.refs), s.bp.peak_used,
            list(s.free), dict(s.slot_owner))


def _apply(s, op, arg):
    if op == "allocate":
        return s.allocate(f"r{arg}")
    if op == "grow":
        slot, n = arg
        return s.ensure_capacity(slot, n) if slot in s.slot_owner else None
    if op == "adopt":
        slot, src = arg
        ids = s.block_ids(src)
        if slot not in s.slot_owner or s.seq_blocks.get(slot) or not ids:
            return None
        s.adopt_prefix(slot, ids, len(ids) * s.block_size)
        return len(ids)
    if op == "trim":
        slot, n = arg
        return s.trim(slot, n)
    if op == "release":
        return s.release(arg) if arg in s.slot_owner else None
    raise ValueError(op)


def _ops(seed, n=40):
    rng = np.random.default_rng(seed)
    kinds = ["allocate", "grow", "grow", "adopt", "trim", "release"]
    out = []
    for _ in range(n):
        op = kinds[rng.integers(len(kinds))]
        slot = int(rng.integers(4))
        arg = {"allocate": slot, "release": slot,
               "grow": (slot, int(rng.integers(1, 140))),
               "trim": (slot, int(rng.integers(1, 100))),
               "adopt": (slot, int(rng.integers(4)))}[op]
        out.append((op, arg))
    return out


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_block_bookkeeping_matches_reference(seed):
    """Alloc, grow, adopt_prefix, trim and release on the same random
    call sequence leave both packages' tables, lengths, refcounts and
    free lists identical."""
    jcfg, tcfg = _cfgs()
    js = JSlots(jcfg, 4, 128, block_size=16, pool_tokens=160)
    ts = PagedCacheSlots(tcfg, 4, 128, block_size=16, pool_tokens=160,
                         device="cpu")
    for op, arg in _ops(seed):
        if op == "allocate" and not js.free:
            continue
        assert _apply(js, op, arg) == _apply(ts, op, arg), (op, arg)
        assert _state(js) == _state(ts), (op, arg)


def test_block_pool_refcounts():
    bp = BlockPool(5)
    ids = bp.alloc(3)
    assert ids == [1, 2, 3] and bp.alloc(2) is None
    bp.incref(ids[:1])
    assert bp.decref(ids) == 2 and bp.refs == {1: 1}
    with pytest.raises(ValueError):
        bp.decref([2])
    with pytest.raises(ValueError):
        BlockPool(1)


def test_insert_prefill_matches_reference():
    """The same prefill cache lands in the same pool positions (including
    the padding positions of the last block)."""
    jcfg, tcfg = _cfgs()
    L, KV, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    js = JSlots(jcfg, 2, 64, block_size=16)
    ts = PagedCacheSlots(tcfg, 2, 64, block_size=16, device="cpu")
    rng = np.random.default_rng(0)
    for S, length in ((32, 21), (32, 32), (64, 40)):
        cache = {n: rng.standard_normal((L, 1, S, KV, hd)).astype(np.float32)
                 for n in ("k", "v")}
        for s in (js, ts):
            slot = s.allocate("x")
            assert s.ensure_capacity(slot, length)
        js.insert_prefill(slot, {"stack": {n: jnp.asarray(a)
                                           for n, a in cache.items()}},
                          length)
        ts.insert_prefill(slot, {"stack": {n: torch.from_numpy(a)
                                           for n, a in cache.items()}},
                          length)
        for n in ("k", "v"):
            want = np.asarray(js.pool["stack"][n].astype(jnp.float32))
            assert np.array_equal(ts.pool["stack"][n].float().numpy(), want)
        for s in (js, ts):
            s.release(slot)


# ----------------------------------------------------------------- engine
def test_engine_reproduces_golden_gqa_tokens():
    g = GOLDEN["gqa"]
    jcfg, tcfg = _cfgs()
    assert g["arch"] == tcfg.name and g["paged"]
    with jax.threefry_partitionable(False):
        jp = JM.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    got, _ = _run_port(tcfg, tp, g["prompts"],
                       [len(w) for w in g["generated"]])
    assert got == g["generated"]


def _traffic(vocab):
    rng = np.random.default_rng(7)
    a = rng.integers(1, vocab, 20).tolist()
    return [a,
            rng.integers(1, vocab, 37).tolist(),          # streamed tail
            rng.integers(1, vocab, 3).tolist(),
            # admitted once a's prompt is indexed: a prefix hit
            a[:16] + rng.integers(1, vocab, 6).tolist()]


def test_engine_matches_jax_engine_chunked(weights):
    """Prompts longer than a small prefill_chunk (8) stream their tail
    through decode micro-steps; one prompt takes a prefix hit.  Tokens
    equal the JAX engine's on the same weights."""
    jcfg, tcfg, jp, tp = weights
    prompts = _traffic(jcfg.vocab_size)
    n = [12, 9, 10, 14]
    want = _run_jax(jcfg, jp, prompts, n, sched=JSched(prefill_chunk=8))
    got, eng = _run_port(tcfg, tp, prompts, n,
                         sched=SchedulerConfig(prefill_chunk=8))
    assert got == want
    cached = [eng.metrics.requests[f"engine0-r{i}"].n_cached
              for i in range(4)]
    assert cached[3] == 16 and sum(cached) == 16
    assert eng.scheduler.prefills == 3


def test_prefix_cache_on_off_identical(weights):
    _, tcfg, _, tp = weights
    prompts = _traffic(tcfg.vocab_size)
    n = [10] * 4
    on, eng = _run_port(tcfg, tp, prompts, n)
    off, _ = _run_port(tcfg, tp, prompts, n,
                       sched=SchedulerConfig(enable_prefix_cache=False))
    assert on == off
    assert eng.metrics.summary()["prefill_tokens_saved"] == 16


def test_preemption_resumes_token_exact(weights):
    """A pool too small for all running requests forces preemption; the
    folded requests resume and every token equals the unconstrained run
    and the JAX engine under the same pressure."""
    jcfg, tcfg, jp, tp = weights
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist()
               for n in (30, 25, 33)]
    n = [20, 20, 20]
    free, _ = _run_port(tcfg, tp, prompts, n)
    tight, eng = _run_port(tcfg, tp, prompts, n, pool_tokens=64)
    assert eng.metrics.summary()["preempted"] > 0
    assert tight == free
    assert _run_jax(jcfg, jp, prompts, n, pool_tokens=64) == free


def test_engine_contract(weights):
    _, tcfg, _, tp = weights
    eng = InferenceEngine(tcfg, tp, max_batch=2, capacity=64, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(Request(prompt=[1, 2, 3], temperature=0.7))
    # a request that can never fit is rejected, not silently finished
    big = Request(prompt=list(range(1, 60)), max_new_tokens=10)
    eng.submit(big)
    eng.run_until_idle()
    assert big.done and eng.metrics.summary()["rejected"] == 1
    # a deadline in the past evacuates in-flight work
    eng.submit(Request(prompt=[5, 6, 7], max_new_tokens=4))
    with pytest.raises(EngineTimeout) as ei:
        eng.run_until_idle(deadline=eng.clock() - 1.0)
    assert len(ei.value.requests) == 1
    eng.crash()
    with pytest.raises(EngineFailure):
        eng.submit(Request(prompt=[1]))
    eng.recover()
    assert eng.health() == "ok"
