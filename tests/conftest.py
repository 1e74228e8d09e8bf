import os
import sys

# Tests must see the single real CPU device (the dry-run sets its own
# device-count flag in its subprocess) — so no XLA_FLAGS here, but cap
# compilation parallelism for the 1-core container.  Exception: the
# sharded-serving suite opts in to N forced host devices by exporting
# REPRO_FORCE_DEVICES before launching pytest (its in-suite subprocess
# wrapper and the CI multi-device job both do); it must be appended
# before the first jax import.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_n_dev = os.environ.get("REPRO_FORCE_DEVICES")
if _n_dev and "xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={int(_n_dev)}").strip()

# Property tests use hypothesis; fall back to the deterministic shim in
# containers that don't ship it (CI installs the real package).
try:
    import hypothesis  # noqa: F401
except ImportError:
    import _hypothesis_shim
    sys.modules["hypothesis"] = _hypothesis_shim
    sys.modules["hypothesis.strategies"] = _hypothesis_shim.strategies

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_config, scaled_down


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on a host without one")


TINY_OVERRIDES = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128,
                      num_heads=4, num_kv_heads=2, head_dim=16)


@pytest.fixture(scope="session")
def tiny_cfg():
    return scaled_down(get_config("qwen1.5-4b"), **TINY_OVERRIDES)


@pytest.fixture(scope="session")
def tiny_params(tiny_cfg):
    from repro.models import model as M
    return M.init(tiny_cfg, jax.random.PRNGKey(0))


def tiny_batch(cfg, B=2, S=16, key=0):
    k = jax.random.PRNGKey(key)
    toks = jax.random.randint(k, (B, S + 1), 1, cfg.vocab_size)
    return {
        "tokens": toks[:, :-1].astype(jnp.int32),
        "targets": toks[:, 1:].astype(jnp.int32),
        "mask": jnp.ones((B, S), jnp.float32),
    }
