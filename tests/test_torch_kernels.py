"""The port's plain kernel versions against the JAX package: each torch
``ref`` is held against the Pallas kernel (interpret mode) and the JAX
``ref``, and, for attention, against the model-level jnp oracle the JAX
model runs.  Inputs come from a numpy seed and feed both sides.

Tolerances: float32 against float32 on the CPU agrees to rounding
(1e-5 for norms, 2e-5 for attention, whose sums run in other orders).
bf16 outputs may differ by one bf16 step (2e-2).  The flash ref follows
the model oracle, which rounds the softmax probabilities to the input
type before the PV product, while the Pallas kernel keeps them in
float32: in bf16 the two are held 2e-2 apart, in float32 they agree.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.decode_attention.ref import decode_ref as jax_decode_ref
from repro.kernels.flash_attention.kernel import flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.paged_attention.kernel import \
    paged_decode_attention as pallas_paged
from repro.kernels.rmsnorm.kernel import rmsnorm as pallas_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.models import attention as jax_attn
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import paged_decode_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

torch.set_num_threads(1)

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(a, dt="f32"):
    """One numpy array as a JAX and a torch array of the same type (the
    bf16 casts round identically on both sides)."""
    jdt, tdt = DT[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _err(got, want) -> float:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(jnp.asarray(got, jnp.float32))
    w = want.float().numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.max(np.abs(g - w)))


# ------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("shape,dt,tol", [
    ((4, 100, 64), "f32", 1e-5),
    ((3, 33), "f32", 1e-5),
    ((2, 7, 130), "bf16", 2e-2),
])
def test_rmsnorm_shapes_dtypes(shape, dt, tol):
    jx, tx = _both(_rand(1, shape), dt)
    jw, tw = _both(_rand(2, (shape[-1],)))
    got = rmsnorm_ref(tx, tw)
    assert got.dtype == tx.dtype
    assert _err(got, pallas_rmsnorm(jx, jw, interpret=True)) < tol
    assert _err(got, jax_rmsnorm_ref(jx, jw)) < tol
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(rms_ops.rmsnorm(tx, tw), got)


@settings(max_examples=10, deadline=None)
@given(rows=st.integers(1, 50), d=st.sampled_from([8, 64, 130]),
       blk=st.sampled_from([4, 16, 256]))
def test_rmsnorm_property(rows, d, blk):
    jx, tx = _both(_rand(51, (rows, d)))
    jw, tw = _both(_rand(52, (d,)))
    got = rmsnorm_ref(tx, tw)
    assert _err(got, pallas_rmsnorm(jx, jw, blk_rows=blk,
                                    interpret=True)) < 1e-5
    assert _err(got, jax_rmsnorm_ref(jx, jw)) < 1e-5


# ------------------------------------------------------------ flash
@pytest.mark.parametrize("dt,tol", [("f32", 2e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("B,KV,G,S,D,blk", [
    (2, 2, 2, 64, 32, 32),
    (1, 1, 4, 48, 16, 16),
    (1, 2, 1, 70, 32, 32),    # ragged -> the Pallas padding path
])
def test_flash_shapes_dtypes(B, KV, G, S, D, blk, dt, tol):
    H = KV * G
    jq, tq = _both(_rand(1, (B, H, S, D)), dt)
    jk, tk = _both(_rand(2, (B, KV, S, D)), dt)
    jv, tv = _both(_rand(3, (B, KV, S, D)), dt)
    got = attention_ref(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == (B, H, S, D)
    assert _err(got, pallas_flash(jq, jk, jv, causal=True, blk_q=blk,
                                  blk_k=blk, interpret=True)) < tol
    assert _err(got, jax_attention_ref(jq, jk, jv, causal=True)) < tol
    # the model oracle, whose math the ref follows exactly
    oracle = jax_attn.blockwise_attention(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
        jnp.swapaxes(jv, 1, 2), causal=True)
    assert _err(got, jnp.swapaxes(oracle, 1, 2).astype(jq.dtype)) < tol
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(flash_ops.flash_attention(tq, tk, tv, causal=True),
                       got)


@settings(max_examples=8, deadline=None)
@given(B=st.integers(1, 2), KV=st.sampled_from([1, 2]),
       G=st.sampled_from([1, 3]), S=st.sampled_from([17, 64, 100]),
       D=st.sampled_from([8, 32]), causal=st.booleans())
def test_flash_property(B, KV, G, S, D, causal):
    H = KV * G
    jq, tq = _both(_rand(11, (B, H, S, D)))
    jk, tk = _both(_rand(12, (B, KV, S, D)))
    jv, tv = _both(_rand(13, (B, KV, S, D)))
    got = attention_ref(tq, tk, tv, causal=causal)
    assert _err(got, pallas_flash(jq, jk, jv, causal=causal, blk_q=32,
                                  blk_k=32, interpret=True)) < 2e-5
    assert _err(got, jax_attention_ref(jq, jk, jv, causal=causal)) < 2e-5


@pytest.mark.parametrize("kv_len", [1, 23, 40])
def test_flash_kv_len_mask(kv_len):
    """Keys at or past ``kv_len`` are masked, as the oracle's
    ``kv_valid_len`` does."""
    B, S, H, KV, D = 2, 40, 4, 2, 16
    jq, tq = _both(_rand(21, (B, S, H, D)))
    jk, tk = _both(_rand(22, (B, S, KV, D)))
    jv, tv = _both(_rand(23, (B, S, KV, D)))
    got = flash_ops.mha(tq, tk, tv, causal=True, kv_len=kv_len)
    want = jax_attn.blockwise_attention(
        jq, jk, jv, causal=True,
        kv_valid_len=jnp.full((B,), kv_len, jnp.int32))
    assert _err(got, want) < 2e-5


# ------------------------------------------------------------ paged decode
def _paged_layout(k, v, bs, seed=0, extra_blocks=0, shuffle=True):
    """Scatter dense per-sequence caches (B,S,KV,D) into a physical pool
    with an (optionally permuted) block table.  Block 0 stays null."""
    B, S, KV, D = k.shape
    W = S // bs
    nb = 1 + B * W + extra_blocks
    ids = np.arange(1, 1 + B * W)
    if shuffle:
        ids = np.random.default_rng(seed).permutation(np.arange(1, nb))[:B * W]
    kp = np.zeros((nb, bs, KV, D), np.float32)
    vp = np.zeros((nb, bs, KV, D), np.float32)
    bt = np.zeros((B, W), np.int32)
    it = iter(ids)
    for b in range(B):
        for j in range(W):
            pid = int(next(it))
            kp[pid] = k[b, j * bs:(j + 1) * bs]
            vp[pid] = v[b, j * bs:(j + 1) * bs]
            bt[b, j] = pid
    return kp, vp, bt


def _paged_port(q, kp, vp, bt, lengths):
    """The port's plain paged decode on numpy inputs (kernel layout)."""
    out = paged_decode_ref(torch.from_numpy(q)[:, None],
                           torch.from_numpy(kp), torch.from_numpy(vp),
                           torch.from_numpy(bt), torch.from_numpy(lengths))
    return out[:, 0]


@pytest.mark.parametrize("B,KV,G,W,bs,D", [
    (2, 2, 2, 4, 16, 64),
    (3, 1, 8, 3, 32, 32),     # MQA-style wide groups
    (1, 8, 2, 8, 16, 128),
    (2, 2, 1, 2, 64, 16),     # MHA (G=1)
])
def test_paged_matches_dense_ref(B, KV, G, W, bs, D):
    H, S = KV * G, W * bs
    q = _rand(1, (B, H, D))
    k = _rand(2, (B, S, KV, D))
    v = _rand(3, (B, S, KV, D))
    # lengths off the block size and a single-token sequence
    lens = [S, max(1, S - bs // 2 - 1), 1][:B] + [S // 2] * max(0, B - 3)
    lengths = np.asarray(lens[:B], np.int32)
    kp, vp, bt = _paged_layout(k, v, bs, seed=B, extra_blocks=5)
    got = _paged_port(q, kp, vp, bt, lengths)
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, lengths)]
    assert _err(got, pallas_paged(*args, interpret=True)) < 2e-5
    assert _err(got, jax_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), args[4])) < 2e-5


@pytest.mark.parametrize("dt,tol", [("f32", 2e-5), ("bf16", 5e-3)])
def test_paged_matches_model_oracle(dt, tol):
    """Against ``models/attention.py paged_decode_attention``, which casts
    q to the pool's type and rounds the normalised probabilities to it
    before the PV product: the ref does the same, so only a rounding tie
    flipped by a differently ordered sum separates them in bf16."""
    B, KV, G, W, bs, D = 3, 2, 2, 3, 16, 32
    H, S = KV * G, W * bs
    kp, vp, bt = _paged_layout(_rand(32, (B, S, KV, D)),
                               _rand(33, (B, S, KV, D)), bs, seed=4,
                               extra_blocks=2)
    q = _rand(31, (B, 1, H, D))
    lengths = np.asarray([S, 21, 1], np.int32)
    jq, tq = _both(q)
    jk, tk = _both(kp, dt)
    jv, tv = _both(vp, dt)
    got = paged_decode_ref(tq, tk, tv, torch.from_numpy(bt),
                           torch.from_numpy(lengths))
    want = jax_attn.paged_decode_attention(jq, jk, jv, jnp.asarray(bt),
                                           jnp.asarray(lengths))
    assert got.dtype == torch.float32
    assert _err(got, want) < tol
    assert torch.equal(paged_ops.paged_decode(tq, tk, tv,
                                              torch.from_numpy(bt),
                                              torch.from_numpy(lengths)),
                       got)


def test_paged_table_permutation_invariant():
    """The same logical sequences through two physical layouts
    (contiguous vs permuted pool) give identical outputs."""
    B, KV, G, W, bs, D = 2, 2, 3, 4, 16, 32
    H, S = KV * G, W * bs
    q = _rand(11, (B, H, D))
    k = _rand(12, (B, S, KV, D))
    v = _rand(13, (B, S, KV, D))
    lengths = np.asarray([S - 3, S // 2 + 1], np.int32)
    out = [_paged_port(q, *_paged_layout(k, v, bs, seed=7, extra_blocks=9,
                                         shuffle=shuffle), lengths)
           for shuffle in (False, True)]
    assert torch.equal(out[0], out[1])


def test_paged_null_tail_blocks_ignored():
    """Table entries past ceil(len/bs) may point at the null block (or
    anything) without changing the output."""
    B, KV, G, W, bs, D = 1, 2, 2, 4, 16, 32
    H, S = KV * G, W * bs
    q = _rand(21, (B, H, D))
    k = _rand(22, (B, S, KV, D))
    v = _rand(23, (B, S, KV, D))
    lengths = np.asarray([bs + 3], np.int32)     # only 2 blocks matter
    kp, vp, bt = _paged_layout(k, v, bs, seed=3)
    want = _paged_port(q, kp, vp, bt, lengths)
    bt2 = bt.copy()
    bt2[0, 2:] = 0
    got = _paged_port(q, kp, vp, bt2, lengths)
    assert torch.equal(got, want)
    assert _err(got, jax_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v),
                                    jnp.asarray(lengths))) < 2e-5


@settings(max_examples=8, deadline=None)
@given(B=st.integers(1, 3), KV=st.sampled_from([1, 2]),
       G=st.sampled_from([1, 4]), W=st.integers(1, 4),
       bs=st.sampled_from([8, 16]), length_frac=st.floats(0.05, 1.0))
def test_paged_property(B, KV, G, W, bs, length_frac):
    H, D, S = KV * G, 16, W * bs
    q = _rand(41, (B, H, D))
    k = _rand(42, (B, S, KV, D))
    v = _rand(43, (B, S, KV, D))
    lengths = np.full((B,), max(1, int(S * length_frac)), np.int32)
    kp, vp, bt = _paged_layout(k, v, bs, seed=W, extra_blocks=3)
    got = _paged_port(q, kp, vp, bt, lengths)
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, lengths)]
    assert _err(got, pallas_paged(*args, interpret=True)) < 2e-5
    assert _err(got, jax_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), args[4])) < 2e-5


def test_wrappers_refuse_other_types():
    """The kernels take float32 and bfloat16 only; the wrapper checks
    before any launch.  (On the CPU the plain versions run as written.)"""
    from repro_torch.kernels import _lib
    with pytest.raises(TypeError):
        _lib.dtype_code(torch.zeros(2, dtype=torch.float16), "test")
    assert _lib.dtype_code(torch.zeros(2, dtype=torch.bfloat16), "t") == 1
