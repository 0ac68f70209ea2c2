"""rsmcrt_tpu: differentiable SDF Monte Carlo radiation transfer in JAX
(see SURVEY.md for the reference map)."""

import os

# Chained megastep programs for complex scenes take minutes to compile, so
# compiled programs persist across processes.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself; without it the cache lives at a fixed
# path in the checkout (a moving path never hits).
CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), os.pardir, ".jax_cache"))

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
