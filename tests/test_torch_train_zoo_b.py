"""The port's training step against the reference's, every config of
the zoo at ``SMOKE`` (this file: the second half of ``ARCH_NAMES``; the
body and its tolerances are in ``tests/_torch_train_zoo.py``).  Weights
come from the reference's ``init_params`` through ``params_from_jax``;
the reference's step is jitted, as its launcher runs it."""
import pytest

from repro.configs import ARCH_NAMES

from _torch_train_zoo import check_arch, few_threads  # noqa: F401


@pytest.mark.parametrize("name", ARCH_NAMES[5:])
def test_train_step_matches_reference(name):
    check_arch(name)
