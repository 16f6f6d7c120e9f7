import os

# Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
# without a GPU; an explicit JAX_PLATFORMS is honoured. Must be set before
# jax import.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent XLA compilation cache: the parity suites compile many small
# integer kernels; caching makes repeat runs fast.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_comp_cache")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
