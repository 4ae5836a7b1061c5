"""The CPU environment of the port's test modules.

The tests run in several pytest-xdist workers on one machine.  Two things
the port's modules would otherwise leave to the workers after them:

* torch starts as many OpenMP threads as the machine has cores in each
  worker, and they spin between the tests' small ops, so the workers'
  threads outnumber the cores and slow every worker, the JAX reference's
  compiles included: a port module runs torch on one thread (its tensors
  are small; nothing a test checks depends on the count);
* the JAX reference models a port module compiles stay in JAX's caches
  for the worker's life, and later compiles in that worker slow down with
  them (on an 8-core machine the reference's `test_hierarchical_step_trains`
  took 1069 s in a worker after two port modules, 622 s when they cleared
  the caches): a port module clears JAX's caches and collects garbage when
  it ends.

Each port test file imports the fixture (autouse, module scope)."""

import gc

import jax
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def port_test_env():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()
    gc.collect()
