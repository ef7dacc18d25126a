"""The port's device element stiffness, ``element_stiffness_torch``,
against the JAX package's ``element_stiffness_jax`` and the host NumPy
kernel, on tests/test_fem.py's distorted unit cubes."""

import numpy as np
import pytest
import torch

from ddpca_admm_tpu.fem.elasticity import element_stiffness_jax
from ddpca_admm_tpu_torch.fem.elasticity import (
    elastic_matrix,
    element_stiffness,
    element_stiffness_torch,
)

UNIT_CUBE = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.float64)


@pytest.mark.parametrize("E,nu", [(210.0e9, 0.3), (1.0e9, 0.45)])
def test_element_stiffness_torch_matches_jax(E, nu):
    """rtol 1e-9 against the JAX function (the same closed-form inverse and
    einsums) and against the host kernel, entry by entry (atol 1e-8, as
    tests/test_fem.py's ``np.allclose``)."""
    D = elastic_matrix(E, nu)
    rng = np.random.default_rng(3)
    exyz = UNIT_CUBE[None] + 0.05 * rng.standard_normal((4, 8, 3))
    K = element_stiffness_torch(exyz, D, device="cpu")
    assert K.dtype == torch.float64 and K.shape == (4, 24, 24)
    K = K.numpy()
    for ref in (np.asarray(element_stiffness_jax(exyz, D)),
                element_stiffness(exyz, D)):
        np.testing.assert_allclose(K, ref, rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(K, np.swapaxes(K, 1, 2), rtol=0,
                               atol=1e-12 * float(np.abs(K).max()))
