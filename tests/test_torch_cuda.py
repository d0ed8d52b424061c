"""Checks that need the card: the LSTM stack kernel and the LSTM training pair
against their plain versions at the released init-RNN shape, and a served
step against the same model run with the plain LSTM. Skipped without a CUDA
device; on the card run

    python -m pytest tests/test_torch_cuda.py -q

Tolerance atol 1e-4 (fp32 on both sides, different summation order; the LGD
gradient input is scaled by n*f).
"""

import copy

import numpy as np
import pytest
import torch

from empose_tpu_torch.bodymodel.smplh import SMPLHModel
from empose_tpu_torch.bodymodel.synthetic import make_synthetic_smplh
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.device import set_precision
from empose_tpu_torch.nn.layers import init_parameters
from empose_tpu_torch.nn.models import SensorSMPL, create_model
from empose_tpu_torch.ops import lstm_kernel as K
from empose_tpu_torch.ops import lstm_train_kernel as TK
from empose_tpu_torch.serve import MultiStreamPredictor

torch.set_num_threads(1)
ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LSTM stack kernel runs only on the card")
    set_precision("highest")
    return torch.device("cuda")


@pytest.mark.parametrize("f", [16, 256])
def test_kernel_matches_plain_released_shape(cuda, f):
    g = torch.Generator().manual_seed(f)
    h, n, layers, n_in = 512, 64, 2, 72
    u = lambda *s: ((torch.rand(*s, generator=g) * 2 - 1) * h ** -0.5).to(cuda)
    cells = [dict(w_ih=u(n_in if l == 0 else h, 4 * h), w_hh=u(h, 4 * h), b_ih=u(4 * h),
                  b_hh=u(4 * h)) for l in range(layers)]
    x = torch.randn(f, n, n_in, generator=g).to(cuda)
    lengths = torch.randint(1, f, (n,), generator=g)
    lengths[:3], lengths[3:10] = 0, f
    mask = (torch.arange(f)[:, None] < lengths[None]).float().to(cuda)
    h0 = (torch.randn(layers, n, h, generator=g) * 0.5).to(cuda)
    c0 = (torch.randn(layers, n, h, generator=g) * 0.5).to(cuda)
    got = K.lstm_stack(cells, x, mask, h0, c0)
    want = K.lstm_stack(cells, x, mask, h0, c0, stack_fn=K.lstm_stack_plain)
    torch.testing.assert_close(got[0], want[0], atol=ATOL, rtol=0)
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    assert torch.equal(got[1][0][:, :3], h0[:, :3]) and torch.equal(got[1][1][:, :3], c0[:, :3])


@pytest.mark.parametrize("f, n", [(64, 16), (256, 64)])
def test_training_pair_matches_plain_released_shape(cuda, f, n):
    """Both sweeps at H=512 against their plain versions (atol 1e-4 relative
    to each output's largest entry), and 0-length rows bit for bit."""
    g = torch.Generator().manual_seed(f + n)
    h = 512
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)
    x_proj, w_hh = r(f, n, 4 * h) * 0.5, r(h, 4 * h) * h ** -0.5
    h0, c0 = r(n, h) * 0.5, r(n, h) * 0.5
    lengths = torch.randint(1, f, (n,), generator=g)
    lengths[:2], lengths[2:6] = 0, f
    mask = (torch.arange(f)[:, None] < lengths[None]).float().to(cuda)
    got = TK.lstm_train_fwd(x_proj, mask, w_hh, h0, c0)
    want = TK.lstm_train_fwd_plain(x_proj, mask, w_hh, h0, c0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL * float(b.abs().max()), rtol=0)
    assert torch.equal(got[1][:, :2], h0[None, :2].expand(f, 2, h))
    c_prev = torch.cat([c0[None], want[2][:-1]])
    dh, dc = r(f, n, h), r(f, n, h)
    got_b = TK.lstm_train_bwd(dh, dc, want[0], c_prev, mask, w_hh)
    want_b = TK.lstm_train_bwd_plain(dh, dc, want[0], c_prev, mask, w_hh)
    for a, b in zip(got_b, want_b):
        torch.testing.assert_close(a, b, atol=ATOL * float(b.abs().max()), rtol=0)
    assert torch.equal(got_b[0][:, :2], torch.zeros_like(got_b[0][:, :2]))
    assert torch.equal(got_b[1][:2], want_b[1][:2]) and torch.equal(got_b[2][:2], want_b[2][:2])


def test_served_step_matches_plain_lstm_forward(cuda):
    npz = make_synthetic_smplh(seed=0)
    pd = npz["posedirs"]
    smplh = SMPLHModel(
        v_template=npz["v_template"].astype(np.float32),
        shapedirs=npz["shapedirs"][..., :10].astype(np.float32),
        posedirs=pd.reshape(-1, pd.shape[-1]).T.astype(np.float32),
        j_regressor=npz["J_regressor"].astype(np.float32),
        weights=npz["weights"].astype(np.float32),
        parents=tuple(int(p) if p < 2 ** 31 else -1 for p in npz["kintree_table"][0]),
        faces=npz["f"].astype(np.int64))
    config = Configuration.from_dict(dict(
        m_type="ief", m_rnn_init=True, m_use_gradient=True, m_average_shape=True,
        m_num_iterations=2, m_hidden_size=512, m_num_layers=2, m_rnn_hidden_size=512,
        m_rnn_num_layers=2, use_marker_pos=True, use_marker_ori=True, n_markers=6))
    model = create_model(config, SensorSMPL(smplh))
    init_parameters(model, torch.Generator().manual_seed(0)).to(cuda)
    ref_model = copy.deepcopy(model)
    ref_model.rnn.lstm_stack = K.lstm_stack_plain
    rng = np.random.RandomState(0)
    streams, chunk = 32, 16
    pos = (rng.randn(streams, 2 * chunk, 36) * 0.3).astype(np.float32)
    ori = (rng.randn(streams, 2 * chunk, 108) * 0.3).astype(np.float32)
    served, ref = MultiStreamPredictor(model, streams, chunk), MultiStreamPredictor(ref_model, streams, chunk)
    for r in range(2):
        for p in (served, ref):
            for s in range(streams):
                if not (r == 0 and s == 1):  # stream 1 idle in the first step
                    p.push(s, pos[s, r * chunk:(r + 1) * chunk], ori[s, r * chunk:(r + 1) * chunk])
        launches = K.LAUNCHES
        got = served.step()
        assert K.LAUNCHES == launches + 1
        want = ref.step()
        assert K.LAUNCHES == launches + 1
        assert sorted(got) == sorted(want)
        for s in want:
            for k in want[s]:
                np.testing.assert_allclose(got[s][k], want[s][k], atol=ATOL)
