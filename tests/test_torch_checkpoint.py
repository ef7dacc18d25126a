"""The port's checkpoint and stepwise loop (``utils/checkpoint.py``,
``admm/loop.py::admm_step`` and ``contact_analysis_stepwise``), the
counterpart of the JAX package's tests/test_aux.py checkpoint test: three
steps, save, load; the next step from either state agrees, and the three
steps agree with the JAX package's ``admm_step``."""

import numpy as np
import pytest
import torch

from ddpca_admm_tpu.admm.loop import admm_step as jax_step
from ddpca_admm_tpu.admm.loop import init_state as jax_init
from ddpca_admm_tpu.models.simple import stacked_boxes_problem as jax_boxes
from ddpca_admm_tpu_torch.admm.loop import (
    admm_step,
    contact_analysis,
    contact_analysis_stepwise,
    init_state,
)
from ddpca_admm_tpu_torch.models.simple import stacked_boxes_problem
from ddpca_admm_tpu_torch.utils.checkpoint import load_state, save_state

torch.set_num_threads(1)

TOL = 1e-8


@pytest.fixture(scope="module")
def boxes():
    prob, meta, _ = stacked_boxes_problem(div_bot=2, div_top=2, levels=0,
                                          device="cpu")
    return prob, tuple(meta.group_modes)


def test_checkpoint_roundtrip_resumes_identically(boxes, tmp_path):
    prob, modes = boxes
    s = init_state(prob)
    for _ in range(3):
        s = admm_step(prob, s, modes)
    path = str(tmp_path / "sub" / "state.pt")
    save_state(path, s)
    s2 = load_state(path, device="cpu")
    assert s2.it == s.it == 3 and isinstance(s2.it, int)
    assert s2.converged is s.converged
    for a, b in zip(s2.groups, s.groups, strict=True):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    hist = s.moni_hist.clone()
    a = admm_step(prob, s, modes)
    assert torch.equal(s.moni_hist, hist)  # the step leaves its input alone
    b = admm_step(prob, s2, modes)
    assert a.it == b.it == 4
    assert torch.equal(a.u, b.u)
    assert all(torch.equal(x.lam, y.lam) for x, y in zip(a.groups, b.groups))

    # the three steps against the JAX package's
    jprob, jmeta, _ = jax_boxes(div_bot=2, div_top=2, levels=0)
    js = jax_init(jprob)
    for _ in range(3):
        js = jax_step(jprob, js, tuple(jmeta.group_modes))
    ref = np.asarray(js.u)
    assert float(np.abs(s2.u.numpy() - ref).max()) <= \
        TOL * float(np.abs(ref).max())


def test_stepwise_ends_where_contact_analysis_ends(boxes):
    prob, modes = boxes
    seen = []
    st = contact_analysis_stepwise(prob, modes, device="cpu",
                                   callback=lambda s: seen.append(s.it))
    ref = contact_analysis(prob, modes, device="cpu")
    assert ref.converged and st.converged
    assert st.it == ref.it
    assert torch.equal(st.u, ref.u)
    # one callback per iteration, none past convergence
    assert seen == list(range(1, st.it + 1))


def test_load_state_refuses_cuda_without_a_card(boxes, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    prob, _ = boxes
    path = str(tmp_path / "state.pt")
    save_state(path, init_state(prob))
    with pytest.raises(RuntimeError, match="cuda"):
        load_state(path)
