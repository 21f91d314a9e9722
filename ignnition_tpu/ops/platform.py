"""Where the hand-written kernels of ops/ run.

One rule for every kernel: it runs where JAX's default backend is the GPU
and the caller's shapes are eligible (an explicit, tested check next to
each kernel). Everywhere else the plain XLA path runs. No path degrades to
another when a kernel fails to compile: the error surfaces. Pallas's
interpreter runs a kernel on the CPU only where a test asks for it.
"""

from __future__ import annotations

import jax


def kernels_enabled() -> bool:
    """True where the ops/ kernels are compiled for the device."""
    return jax.default_backend() == "gpu"
