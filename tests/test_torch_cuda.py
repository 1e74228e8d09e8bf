"""The hand-written CUDA kernels against their plain PyTorch versions on
the card.  Marked ``cuda``: they skip on a host without one.  This file
imports no JAX, so it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: float32 kernels agree with the plain versions to rounding
(2e-5; sums run in other orders).  bf16 outputs may differ by one bf16
step (2e-2 absolute and relative); the paged-decode and paged-verify
kernels keep their softmax probabilities in float32 where the plain
versions round them to bf16, which stays within the same bound for one
kernel call and within 1e-2 on the logits of a whole step over a bf16
pool.  The int8 kernels meet a float32 cache in their plain versions
too (dequantized codes), so they are held to 2e-5 whatever q's type.
"""
import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch.kernels import KERNELS, PLAIN, launch_counts, \
    reset_launch_counts
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import blockwise_attention
from repro_torch.kernels.paged_attention.ops import (paged_decode,
                                                     paged_decode_int8,
                                                     paged_verify,
                                                     paged_verify_int8)
from repro_torch.kernels.paged_attention.ref import (paged_decode_int8_ref,
                                                     paged_decode_ref,
                                                     paged_verify_int8_ref,
                                                     paged_verify_ref)
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models import model as TM
from repro_torch.models.param import tree_map
from repro_torch.serving.engine import InferenceEngine, Request

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("shape,dtype,wdtype", [
    ((512, 2560), torch.bfloat16, torch.bfloat16),
    ((37, 2560), torch.bfloat16, torch.float32),
    ((5, 130), torch.bfloat16, torch.bfloat16),     # off the 16-byte vector
    ((4, 100, 64), torch.float32, torch.float32),
])
def test_rmsnorm_kernel(dev, shape, dtype, wdtype):
    x = _rand(shape, dtype, dev, 1)
    w = _rand(shape[-1:], wdtype, dev, 2)
    before = rmsnorm.launches
    _close(rmsnorm(x, w), rmsnorm_ref(x, w), dtype)
    assert rmsnorm.launches == before + 1


@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 512, 20, 20, 128), (2, 100, 32, 8, 128), (1, 77, 4, 2, 32),
    (1, 1, 4, 1, 64), (2, 130, 8, 2, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel(dev, B, S, H, KV, D, dtype):
    q = _rand((B, S, H, D), dtype, dev, 1)
    k = _rand((B, S, KV, D), dtype, dev, 2)
    v = _rand((B, S, KV, D), dtype, dev, 3)
    _close(mha(q, k, v, causal=True),
           blockwise_attention(q, k, v, causal=True), dtype)
    _close(mha(q, k, v, causal=False),
           blockwise_attention(q, k, v, causal=False), dtype)
    _close(mha(q, k, v, causal=True, kv_len=S // 2 + 1),
           blockwise_attention(q, k, v, causal=True, kv_len=S // 2 + 1),
           dtype)


@pytest.mark.parametrize("B,H,KV,D,lens", [
    (8, 20, 20, 128, [445, 349, 256, 185, 202, 82, 264, 600]),
    (4, 32, 8, 128, [1, 17, 250, 1000]),
    (3, 4, 2, 32, [16, 1, 33])])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_kernel(dev, B, H, KV, D, lens, dtype):
    blk, W = 16, 64
    need = [-(-n // blk) for n in lens]
    nb = 1 + sum(need) + 3
    kp = _rand((nb, blk, KV, D), dtype, dev, 1)
    vp = _rand((nb, blk, KV, D), dtype, dev, 2)
    ids = iter((np.random.default_rng(0).permutation(nb - 1) + 1).tolist())
    tables = np.zeros((B, W), np.int32)      # null tail entries
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = next(ids)
    bt = torch.from_numpy(tables).to(dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = _rand((B, 1, H, D), dtype, dev, 3)
    _close(paged_decode(q, kp, vp, bt, ln),
           paged_decode_ref(q, kp, vp, bt, ln), dtype)


def _pools(dev, B, KV, D, lens, dtype, blk=16, W=64, seed=1):
    """Random pools with a permuted table whose entries past
    ceil(len / blk) are the null block 0; int8 pools come with
    (num_blocks, KV) float32 scales."""
    need = [-(-n // blk) for n in lens]
    nb = 1 + sum(need) + 3
    ids = iter((np.random.default_rng(seed).permutation(nb - 1)
                + 1).tolist())
    tables = np.zeros((B, W), np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = next(ids)
    bt = torch.from_numpy(tables).to(dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    if dtype != torch.int8:
        return (_rand((nb, blk, KV, D), dtype, dev, seed),
                _rand((nb, blk, KV, D), dtype, dev, seed + 1), bt, ln)
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = [torch.randint(-127, 128, (nb, blk, KV, D), generator=g,
                           device=dev).to(torch.int8) for _ in range(2)]
    scales = [torch.rand((nb, KV), generator=g, device=dev) * 0.02
              for _ in range(2)]
    return codes[0], codes[1], scales[0], scales[1], bt, ln


VERIFY_CASES = [
    # B, H, KV, D, lengths, T: the main path (H = KV = 20, D = 128) with
    # tails straddling a block, GQA, short rows and one row of length T
    (8, 20, 20, 128, [98, 130, 256, 161, 202, 82, 264, 616], 5),
    (8, 20, 20, 128, [98, 130, 256, 161, 202, 82, 264, 616], 2),
    (4, 32, 8, 128, [5, 17, 250, 1000], 5),
    (3, 4, 2, 32, [16, 3, 33], 3),
    (2, 8, 2, 64, [1, 64], 1),
]


@pytest.mark.parametrize("B,H,KV,D,lens,T", VERIFY_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_verify_kernel(dev, B, H, KV, D, lens, T, dtype):
    kp, vp, bt, ln = _pools(dev, B, KV, D, lens, dtype)
    q = _rand((B, T, H, D), dtype, dev, 3)
    before = paged_verify.launches
    got = paged_verify(q, kp, vp, bt, ln)
    assert paged_verify.launches == before + 1
    _close(got, paged_verify_ref(q, kp, vp, bt, ln), dtype)
    if T == 1:      # the decode kernel's arithmetic, in the same order
        assert torch.equal(got, paged_decode(q, kp, vp, bt, ln))


@pytest.mark.parametrize("B,H,KV,D,lens,T", VERIFY_CASES)
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
def test_paged_int8_kernels(dev, B, H, KV, D, lens, T, qdtype):
    kq, vq, ks, vs, bt, ln = _pools(dev, B, KV, D, lens, torch.int8)
    q = _rand((B, T, H, D), qdtype, dev, 4)
    got = paged_verify_int8(q, kq, vq, ks, vs, bt, ln)
    _close(got, paged_verify_int8_ref(q, kq, vq, ks, vs, bt, ln),
           torch.float32)
    d = paged_decode_int8(q[:, :1], kq, vq, ks, vs, bt, ln)
    _close(d, paged_decode_int8_ref(q[:, :1], kq, vq, ks, vs, bt, ln),
           torch.float32)
    if T == 1:
        assert torch.equal(got, d)


def test_wrappers_reject_bad_inputs(dev):
    x = torch.zeros(4, 64, dtype=torch.float16, device=dev)
    with pytest.raises(TypeError):
        rmsnorm(x, torch.ones(64, dtype=torch.float16, device=dev))
    q = torch.zeros(1, 8, 2, 48, device=dev)
    with pytest.raises(ValueError):
        mha(q, q, q)                         # head dim 48 not built
    with pytest.raises(ValueError):
        rmsnorm(torch.zeros(4, 64, device=dev), torch.ones(64))
    kq, vq, ks, vs, bt, ln = _pools(dev, 2, 2, 32, [5, 9], torch.int8)
    q = torch.zeros(2, 3, 4, 32, device=dev)
    with pytest.raises(TypeError):          # not an int8 pool
        paged_verify_int8(q, kq.float(), vq.float(), ks, vs, bt, ln)
    with pytest.raises(TypeError):          # scales must be float32
        paged_verify_int8(q, kq, vq, ks.double(), vs, bt, ln)
    with pytest.raises(ValueError):         # decode takes one query
        paged_decode_int8(q, kq, vq, ks, vs, bt, ln)
    with pytest.raises(TypeError):          # int8 pools need the int8 path
        paged_verify(q, kq, vq, bt, ln)


def test_model_steps_kernels_vs_plain(dev):
    """Prefill and a paged decode step of the scaled-down model in f32:
    the kernel path against the plain versions on the same card."""
    cfg = TC.scaled_down(TC.get_config("qwen1.5-4b"))
    params = TM.init(cfg, seed=0, device=dev)
    toks = torch.randint(1, cfg.vocab_size, (2, 64), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    batch = {"tokens": toks,
             "prompt_lengths": torch.tensor([64, 40], device=dev)}
    reset_launch_counts()
    lk, ck, _ = TM.prefill(cfg, params, batch, kernels=KERNELS)
    L = cfg.num_layers
    assert launch_counts() == {"rmsnorm": 2 * L + 1, "flash_attention": L,
                               "paged_decode_attention": 0,
                               "paged_verify_attention": 0,
                               "paged_decode_attention_int8": 0,
                               "paged_verify_attention_int8": 0}
    lp, cp, _ = TM.prefill(cfg, params, batch, kernels=PLAIN)
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    pool = TM.make_paged_pool(cfg, 9, 16, device=dev)
    pool["stack"]["k"][:, 1:5] = ck["stack"]["k"][:, 0].reshape(
        L, 4, 16, cfg.num_kv_heads, cfg.head_dim).to(torch.bfloat16)
    pool["stack"]["v"][:, 1:5] = ck["stack"]["v"][:, 0].reshape(
        L, 4, 16, cfg.num_kv_heads, cfg.head_dim).to(torch.bfloat16)
    tables = torch.tensor([[1, 2, 3, 4, 5], [0, 0, 0, 0, 0]],
                          dtype=torch.int32, device=dev)
    lens = torch.tensor([65, 1], dtype=torch.int32, device=dev)
    tok = lk.argmax(-1, keepdim=True).to(torch.int32)
    plain_pool = tree_map(lambda t: t.clone(), pool)
    dk, _ = TM.decode_step_paged(cfg, params, tok, pool, tables, lens)
    dp, _ = TM.decode_step_paged(cfg, params, tok, plain_pool, tables, lens,
                                 kernels=PLAIN)
    # the decode kernel keeps p in float where the plain version rounds
    # the normalised p to the bf16 pool type (a 2^-9 relative step)
    torch.testing.assert_close(dk[:1], dp[:1], atol=1e-2, rtol=0)


def test_engine_tokens_card_vs_cpu(dev):
    cfg = TC.scaled_down(TC.get_config("qwen1.5-4b"))
    cpu = TM.init(cfg, seed=0, device="cpu")
    gpu = tree_map(lambda t: t.to(dev), cpu)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 40, 70)]
    out = []
    for params, d in ((gpu, dev), (cpu, "cpu")):
        eng = InferenceEngine(cfg, params, max_batch=4, capacity=128,
                              device=d)
        reqs = [Request(prompt=p, max_new_tokens=12) for p in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        out.append([r.generated for r in reqs])
    assert out[0] == out[1]


def test_model_verify_steps_kernels_vs_plain(dev):
    """A verify step (T = 4, a tail straddling a block) and an int8 decode
    step of the scaled-down model in f32: the kernel path against the
    plain versions on the same card, with each kernel launched once a
    layer."""
    cfg = TC.scaled_down(TC.get_config("qwen1.5-4b"))
    L = cfg.num_layers
    params = TM.init(cfg, seed=0, device=dev)
    tables = torch.tensor([[1, 2, 3], [4, 5, 0], [0, 0, 0]],
                          dtype=torch.int32, device=dev)
    lens = torch.tensor([34, 18, 1], dtype=torch.int32, device=dev)
    toks = torch.tensor([[11, 4, 9, 2], [3, 3, 8, 1], [0, 0, 0, 0]],
                        dtype=torch.int32, device=dev)
    for kv in ("bf16", "int8"):
        if kv == "bf16":
            pool = TM.make_paged_pool(cfg, 8, 16, device=dev)
        else:
            pool = TM.make_quantized_paged_pool(cfg, 8, 16, device=dev)
        for n in ("k", "v"):
            x = _rand(pool["stack"][n].shape, torch.float32, dev, 5)
            pool["stack"][n].copy_((x * 40).clamp(-127, 127)
                                   if kv == "int8" else x)
            if kv == "int8":
                pool["stack"][n + "_scale"].fill_(0.01)
        for T, step in ((4, TM.verify_step_paged), (1, TM.decode_step_paged)):
            a_pool = tree_map(lambda t: t.clone(), pool)
            b_pool = tree_map(lambda t: t.clone(), pool)
            reset_launch_counts()
            lk, _ = step(cfg, params, toks[:, :T], a_pool, tables, lens)
            counts = launch_counts()
            name = {(4, "bf16"): "paged_verify_attention",
                    (1, "bf16"): "paged_decode_attention",
                    (4, "int8"): "paged_verify_attention_int8",
                    (1, "int8"): "paged_decode_attention_int8"}[T, kv]
            assert counts[name] == L and counts["rmsnorm"] == 2 * L + 1
            assert sum(counts.values()) == 3 * L + 1
            lp, _ = step(cfg, params, toks[:, :T], b_pool, tables, lens,
                         kernels=PLAIN)
            # bf16 pool: the kernels keep p in float where the plain
            # versions round the normalised p to bf16 (a 2^-9 relative
            # step), over 4 layers; int8 pool: both meet float32 values
            # and differ by sum order and by int8 codes that a last-bit
            # change of K/V rounds the other way
            torch.testing.assert_close(lk[:2], lp[:2], rtol=0,
                                       atol=2e-2 if kv == "bf16" else 1e-3)


def _serve(cfg, params, dev, prompts, n, **kw):
    eng = InferenceEngine(cfg, params, max_batch=4, capacity=128,
                          device=dev, **kw)
    reqs = [Request(prompt=list(p), max_new_tokens=n) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return [r.generated for r in reqs]


def test_spec_and_int8_engines_card_vs_cpu(dev):
    """Scaled-down model in f32: the speculative engine's tokens on the
    card equal its plain tokens and the CPU's; the int8 engines (with and
    without speculation) agree with the CPU's plain tokens at >= 0.90."""
    cfg = TC.scaled_down(TC.get_config("qwen1.5-4b"))
    cpu = TM.init(cfg, seed=0, device="cpu")
    gpu = tree_map(lambda t: t.to(dev), cpu)
    rng = np.random.default_rng(4)
    pat = rng.integers(1, cfg.vocab_size, 7).tolist()
    prompts = [pat * 3 + [5], rng.integers(1, cfg.vocab_size, 40).tolist(),
               pat * 2]
    plain = _serve(cfg, cpu, "cpu", prompts, 12)
    assert _serve(cfg, gpu, dev, prompts, 12, speculative="ngram",
                  spec_k=4) == plain
    assert _serve(cfg, cpu, "cpu", prompts, 12, speculative="ngram",
                  spec_k=4) == plain
    for kw in ({}, {"speculative": "ngram", "spec_k": 4}):
        got = _serve(cfg, gpu, dev, prompts, 12, kv_dtype="int8", **kw)
        hit = sum(a == b for g, w in zip(got, plain) for a, b in zip(g, w))
        assert hit / sum(len(w) for w in plain) >= 0.90
