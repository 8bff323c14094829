import jax
import jax.numpy as jnp
import numpy as np
import pytest

# NOTE: no xla_force_host_platform_device_count here — smoke tests and
# benches must see 1 device.  Multi-device behaviour is exercised through
# subprocess drivers (tests/drivers/) which set XLA_FLAGS before importing
# jax.


def toy_batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (B, S)),
                               jnp.int32),
         "labels": jnp.asarray(rng.integers(0, cfg.vocab_size, (B, S)),
                               jnp.int32),
         "loss_mask": jnp.ones((B, S), jnp.float32)}
    if cfg.family == "audio":
        b["frames"] = jnp.asarray(
            rng.normal(size=(B, cfg.frontend_frames, cfg.frontend_dim)),
            jnp.bfloat16)
    if cfg.vision_dim:
        K = min(cfg.max_image_tokens or 8, S)
        b["image_embeds"] = jnp.asarray(
            rng.normal(size=(B, K, cfg.vision_dim)), jnp.bfloat16)
        pos = np.stack([rng.choice(S, K, replace=False) for _ in range(B)])
        b["image_pos"] = jnp.asarray(pos, jnp.int32)
        b["image_valid"] = jnp.asarray(rng.integers(0, 2, (B, K)),
                                       jnp.int32)
    return b


@pytest.fixture
def rng_key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where there is none")
