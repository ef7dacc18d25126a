"""The port's example model constructors (copied numpy/scipy host code)
against the JAX package's: TORSION, BEAM and CYLINDER built by both
packages give the same constrained systems, region operators and bodies,
bit for bit, and the same operator formats."""

import pytest
import torch

from ddpca_admm_tpu_torch.cli import SMALL_BEAM, SMALL_CYLINDER, SMALL_TORSION
from torch_parity import assert_models_same, format_signature

torch.set_num_threads(1)


def _torsion(pkg):
    if pkg == "jax":
        from ddpca_admm_tpu.models.torsion import (
            TorsionConfig,
            build_torsion_model,
        )

        return build_torsion_model(TorsionConfig(**SMALL_TORSION))
    from ddpca_admm_tpu_torch.models.torsion import (
        TorsionConfig,
        build_torsion_model,
    )

    return build_torsion_model(TorsionConfig(**SMALL_TORSION), device="cpu")


def _beam(pkg):
    if pkg == "jax":
        from ddpca_admm_tpu.models.beam import BeamConfig, build_beam_model

        return build_beam_model(BeamConfig(**SMALL_BEAM))
    from ddpca_admm_tpu_torch.models.beam import BeamConfig, build_beam_model

    return build_beam_model(BeamConfig(**SMALL_BEAM), device="cpu")


# the stack of the JAX package's test_cylinder_stack.py (4 quadrant sections
# x mirror halves, 1 copy)
CYLINDER_STACK4 = dict(SMALL_CYLINDER, loca_leve=3, stack4=True, copy_numb=1)


def _cylinder(pkg, kw):
    if pkg == "jax":
        from ddpca_admm_tpu.models.cylinder import (
            CylinderConfig,
            build_cylinder_model,
        )

        return build_cylinder_model(CylinderConfig(**kw))
    from ddpca_admm_tpu_torch.models.cylinder import (
        CylinderConfig,
        build_cylinder_model,
    )

    return build_cylinder_model(CylinderConfig(**kw), device="cpu")


@pytest.mark.parametrize("example", ["torsion", "beam", "cylinder",
                                     "cylinder_stack4"])
def test_example_model_matches_jax_bit_for_bit(example):
    build = {
        "torsion": _torsion,
        "beam": _beam,
        "cylinder": lambda pkg: _cylinder(pkg, SMALL_CYLINDER),
        "cylinder_stack4": lambda pkg: _cylinder(pkg, CYLINDER_STACK4),
    }[example]
    prob_j, meta_j, bodies_j, cfg_j = build("jax")
    prob, meta, bodies, cfg = build("torch")
    assert vars(cfg) == vars(cfg_j)
    assert_models_same(meta, meta_j, bodies, bodies_j)
    # the port picks the JAX package's operator formats (every level of
    # these examples is ELL: K1, the PlaneDia kernel, has no work here)
    sig = format_signature(prob)
    assert sig == format_signature(prob_j)
    assert {f for _, f in sig if isinstance(f, str)} == {"Ell"}
    assert prob.cons_forc.device.type == "cpu"
    if example == "cylinder_stack4":
        assert len(bodies) == 8
    if example.startswith("cylinder"):
        # variant A (the LATIN macroscopic correction, musc_sett=1) and the
        # mixed scalar + vector group layout
        assert len(prob.coarse) == 1
        assert set(meta.group_modes) == {"scalar", "vector"}
