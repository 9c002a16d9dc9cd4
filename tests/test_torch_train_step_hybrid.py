"""One train step of hymba-1.5b, the hybrid family (its attention and SSM heads; the
selective scan through the autograd Function and the plain backward), against the JAX
package on the CPU: :func:`test_torch_train.train_step_matches_jax` (the
loss, every gradient and the AdamW update within ``TOL``, atol 1e-5 / rtol
1e-4), with remat on and off, at one and two microbatches.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_train_step_hybrid.py``.
"""

import pytest

from test_torch_train import one_thread, train_step_matches_jax  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", ["hymba-1.5b"])
@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_jax(remat, microbatch, arch):
    train_step_matches_jax(remat, microbatch, arch)
