"""The AHRL captioner's training steps on two data-parallel ranks (gloo,
CPU) against the JAX package's ``cross_mesh_common.run_stepfactory_case``
on its (2, 1) mesh: warmstart, value warmstart, an RL worker and an RL
manager step and a greedy decode, from the port's initial parameters with
the one process's draws fed to JAX (test_torch_port_mesh_steps.py has the
set-up, BMHRL's case and the ranks against one process).

Tolerances, those of the one-process step tests: tokens identical; losses
1e-5 relative; parameters 1e-5 absolute (f32)."""
import pytest
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

import test_torch_port_mesh_steps as base


@pytest.fixture(scope="module")
def runs():
    return base.run_modes(("AHRL",))


def test_ahrl_steps_equal_jax_on_its_mesh(runs):
    base.assert_equal_jax_on_its_mesh(runs, "AHRL")
