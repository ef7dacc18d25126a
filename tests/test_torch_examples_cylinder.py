"""CYLINDER, the Hertz line contact, solved by the port (``device="cpu"``)
against the JAX package: the JAX CLI's small configuration cut to
loca_leve=3 (4 bodies, 2,560 padded rows each), the first path of the port
through coarse correction variant A (musc_sett=1, dense coarse inverse) and
a mixed scalar + vector group layout.  Same iteration count, and u, z,
lambda, gamma within 1e-8 of their largest entries.  (loca_leve=2 leaves
the scalar group without interface rows and fails in both packages.)"""

import numpy as np
import pytest
import torch

from ddpca_admm_tpu.admm.loop import contact_analysis as jax_contact_analysis
from ddpca_admm_tpu.models.cylinder import CylinderConfig as JCylinderConfig
from ddpca_admm_tpu.models.cylinder import (
    build_cylinder_model as jax_build_cylinder,
)
from ddpca_admm_tpu_torch.admm.loop import contact_analysis
from ddpca_admm_tpu_torch.cli import SMALL_CYLINDER
from ddpca_admm_tpu_torch.models.cylinder import (
    CylinderConfig,
    build_cylinder_model,
)
from torch_parity import assert_states_match

torch.set_num_threads(1)

CYLINDER = dict(SMALL_CYLINDER, loca_leve=3)


def test_cylinder_variant_a_matches_jax():
    prob_j, meta_j, _, _ = jax_build_cylinder(JCylinderConfig(**CYLINDER))
    prob, meta, bodies, cfg = build_cylinder_model(CylinderConfig(**CYLINDER),
                                                   device="cpu")
    assert meta.group_modes == meta_j.group_modes == ["scalar", "vector"]
    assert len(prob.coarse) == 1 and prob.coarse[0].mg is None
    np.testing.assert_array_equal(prob.coarse[0].inv.numpy(),
                                  np.asarray(prob_j.coarse[0].inv))
    ref = jax_contact_analysis(prob_j, tuple(meta_j.group_modes),
                               max_iter=3000)
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=3000,
                          device="cpu")
    assert_states_match(st, ref)
    # inner CG counts may drift by rounding (float32 V-cycle): 1%
    assert abs(st.inner_iters - int(ref.inner_iters)) <= \
        0.01 * int(ref.inner_iters)
    # each mirror half's contact (the scalar group) transmits half the
    # applied line load
    f_line = abs(cfg.load_inte) * cfg.leng
    for slot, ri in enumerate(meta.group_region_idx[0]):
        ip = meta.regions[ri].region.ip
        gn = st.groups[0].gamma[slot].numpy()[: ip.n]
        assert float(gn @ ip.weight) == pytest.approx(f_line / 2, rel=0.05)
