import os

import pytest

# Tests run on a virtual 8-device CPU mesh: the standard fake-backend trick
# for validating multi-device sharding without hardware. Tests marked
# ``gpu`` need the card: run them there with
#   JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu():
    """The card, for tests marked ``gpu``; skips where JAX finds none."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX's default backend is "
                    f"{jax.default_backend()!r}")
    return jax.devices()[0]
