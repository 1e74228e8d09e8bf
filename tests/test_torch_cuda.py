"""The hand-written CUDA kernels against their plain PyTorch versions on
the card.  Marked ``cuda``: they skip on a host without one.  This file
imports no JAX, so it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: float32 kernels agree with the plain versions to rounding
(2e-5; sums run in other orders).  bf16 outputs may differ by one bf16
step (2e-2 absolute and relative); the paged-decode kernel keeps its
softmax probabilities in float32 where the plain version rounds them to
bf16, which stays within the same bound for one kernel call and within
1e-2 on the logits of a whole decode step over a bf16 pool.
"""
import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch.kernels import KERNELS, PLAIN, launch_counts, \
    reset_launch_counts
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import blockwise_attention
from repro_torch.kernels.paged_attention.ops import paged_decode
from repro_torch.kernels.paged_attention.ref import paged_decode_ref
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


def test_wrappers_reject_bad_inputs(dev):
    x = torch.zeros(4, 64, dtype=torch.float16, device=dev)
    with pytest.raises(TypeError):
        rmsnorm(x, torch.ones(64, dtype=torch.float16, device=dev))
    q = torch.zeros(1, 8, 2, 48, device=dev)
    with pytest.raises(ValueError):
        mha(q, q, q)                         # head dim 48 not built
    with pytest.raises(ValueError):
        rmsnorm(torch.zeros(4, 64, device=dev), torch.ones(64))


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
                               "paged_decode_attention": 0}
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
