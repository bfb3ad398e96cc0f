"""The environment every port test module runs in (a helper, never
collected): ``port_module_env()`` is entered by each module's autouse
fixture and undone when the module ends.

- JAX's persistent compile cache is off (``tests/conftest.py`` turns it
  on; it corrupts the JAX serve decode loop on the CPU, ROADMAP C2).
- torch computes on one intra-op thread.  The suite runs in 6 xdist
  workers on 8 cores, beside XLA's own thread pool, so a
  worker's 8 torch threads only contend with the other workers' (the
  port's tensors here are small); the gloo rank launches already run
  with ``OMP_NUM_THREADS=1``.  ``threads=None`` leaves torch's count
  as it is, for a module whose comparison sits near its tolerance in
  either summation order (``tests/test_torch_quant_steps.py``).
"""

import contextlib
from typing import Optional

import jax
import torch


@contextlib.contextmanager
def port_module_env(compile_cache_off: bool = True,
                    threads: Optional[int] = 1):
    prev = jax.config.jax_enable_compilation_cache
    prev_threads = torch.get_num_threads()
    if compile_cache_off:
        jax.config.update("jax_enable_compilation_cache", False)
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        yield
    finally:
        torch.set_num_threads(prev_threads)
        jax.config.update("jax_enable_compilation_cache", prev)
