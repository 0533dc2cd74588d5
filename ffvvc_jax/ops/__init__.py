"""Device ops package.

Configures JAX's persistent compilation cache on import, so a process that
decodes on the accelerator reuses the kernels an earlier process compiled.
`JAX_COMPILATION_CACHE_DIR`, when set, is the cache (JAX reads it itself);
otherwise the cache lives at a fixed path inside the checkout
(`<repo>/.jax_cache`, gitignored).  The path is part of the cache key, so it
never varies by host, process or time.  The forced-CPU backend (tests,
virtual meshes) gets no persistent cache: its compiles are fast, and CPU
executables carry host-feature assumptions that do not survive a copy to
another machine.
"""
import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

if os.environ.get("JAX_PLATFORMS") != "cpu":
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
