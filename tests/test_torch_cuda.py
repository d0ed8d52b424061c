"""Checks that need the card: the LSTM stack kernel, its wavefront schedule,
the bidirectional layer kernel and the LSTM training pair against their
plain versions at the released widths (H=512, and H=1024; the stack and its
wavefront schedule, the bidirectional layer and each sweep also launched
twice bit for bit, and captured in a CUDA graph; the stack wrapper
allocating nothing but its results), the LBS kernel
against its plain version at the full mesh (and captured in a CUDA graph),
SMPLLayer's launches, and served steps
(LGD-RNN, BiRNN, and both RNNs at the default width 2x1024) against the same
model run with the plain LSTM. Skipped
without a CUDA device; on the card run

    python -m pytest tests/test_torch_cuda.py -q

Tolerance atol 1e-4 (fp32 on both sides, different summation order; the LGD
gradient input is scaled by n*f); the LBS kernel atol 2e-5 (coordinates of a
metre, 52 joints). The stack, wavefront and bidi kernels also run at the
high and default precision modes (their bf16 tensor-core branches) against
their plain versions at the same mode, captured in CUDA graphs, and served
(MODE_ATOL below; the bidi layer and the stack also on the smoke's inputs,
BIDI_MODE_TOL); so do both training sweeps (PAIR_MODE_REL).
"""

import copy

import numpy as np
import pytest
import torch

from empose_tpu_torch.bodymodel.smplh import SMPLHModel, SMPLLayer
from empose_tpu_torch.bodymodel.synthetic import make_synthetic_smplh
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.device import precision_scope, set_precision
from empose_tpu_torch.nn.layers import init_parameters
from empose_tpu_torch.nn.models import SensorSMPL, create_model
from empose_tpu_torch.ops import lstm_kernel as K
from empose_tpu_torch.ops import lstm_train_kernel as TK
from empose_tpu_torch.ops import skinning as SK
from empose_tpu_torch.serve import MultiStreamPredictor

torch.set_num_threads(1)
ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LSTM kernels run only on the card")
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


@pytest.mark.parametrize("f, n", [(16, 64), (256, 64), (16, 1)])
def test_wavefront_kernel_matches_plain_and_stack(cuda, f, n):
    """The wavefront schedule at the released init-RNN shape: atol 1e-4
    against its plain version and against the stack kernel, 0-length rows
    frozen bit for bit, one launch."""
    g = torch.Generator().manual_seed(f + n + 2)
    h, layers, n_in = 512, 2, 72
    u = lambda *s: ((torch.rand(*s, generator=g) * 2 - 1) * h ** -0.5).to(cuda)
    cells = [dict(w_ih=u(n_in if l == 0 else h, 4 * h), w_hh=u(h, 4 * h), b_ih=u(4 * h),
                  b_hh=u(4 * h)) for l in range(layers)]
    x = torch.randn(f, n, n_in, generator=g).to(cuda)
    lengths = torch.randint(1, f, (n,), generator=g)
    lengths[: n // 16] = 0
    lengths[n // 16: n // 16 + n // 3] = f
    mask = (torch.arange(f)[:, None] < lengths[None]).float().to(cuda)
    h0, c0 = (torch.randn(2, layers, n, h, generator=g) * 0.5).to(cuda)
    launches = K.WAVEFRONT_LAUNCHES
    got = K.lstm_stack_wavefront(cells, x, mask, h0, c0)
    assert K.WAVEFRONT_LAUNCHES == launches + 1
    for want in (K.lstm_stack_wavefront(cells, x, mask, h0, c0, K.lstm_stack_wavefront_plain),
                 K.lstm_stack(cells, x, mask, h0, c0)):
        torch.testing.assert_close(got[0], want[0], atol=ATOL, rtol=0)
        for a, b in zip(got[1], want[1]):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    idle = (lengths == 0).to(cuda)
    assert torch.equal(got[1][0][:, idle], h0[:, idle]) and torch.equal(got[1][1][:, idle], c0[:, idle])


def _stack_case(f, n, h, layers, seed, cuda):
    """Kernel operands of an L-layer stack of width h: 0-length rows 0-1,
    full rows 2-5, the rest partial; non-zero state."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: ((torch.rand(*s, generator=g) * 2 - 1) * h ** -0.5).to(cuda)
    x0_proj = (torch.randn(f, n, 4 * h, generator=g) * 0.5).to(cuda)
    w_hh = u(layers, h, 4 * h)
    w_ih_up = u(layers - 1, h, 4 * h) if layers > 1 else None
    b_up = u(layers - 1, 4 * h) if layers > 1 else None
    lengths = torch.randint(1, f, (n,), generator=g)
    lengths[:2], lengths[2:6] = 0, f
    mask = (torch.arange(f)[:, None] < lengths[None]).float().to(cuda)
    h0, c0 = (torch.randn(2, layers, n, h, generator=g) * 0.5).to(cuda)
    return (x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0), (lengths == 0).to(cuda)


@pytest.mark.parametrize("f, n, h, layers", [(16, 64, 1024, 1), (33, 100, 512, 2)])
def test_stack_kernel_matches_plain_default_width_and_ragged(cuda, f, n, h, layers):
    """One layer of the default width H=1024 (U=8, a one-slot ring) and a
    ragged batch of more rows than one staging holds at 2x512 (a ring of two
    slots, the last chunk partial): the stack kernel and, from 2 layers, its
    wavefront schedule against their plain versions, atol 1e-4, one launch
    per call, 0-length rows frozen bit for bit, a second call bit for bit
    equal to the first."""
    args, idle = _stack_case(f, n, h, layers, f + n + h, cuda)
    schedules = [(K.lstm_stack_fused, K.lstm_stack_plain, "LAUNCHES")]
    if layers > 1:
        schedules.append((K.lstm_stack_wavefront_fused, K.lstm_stack_wavefront_plain,
                          "WAVEFRONT_LAUNCHES"))
    for fused, plain, counter in schedules:
        launches = getattr(K, counter)
        got, again = fused(*args), fused(*args)
        assert getattr(K, counter) == launches + 2
        for a, b, c in zip(got, plain(*args), again):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
            assert torch.equal(a, c)
        assert torch.equal(got[1][:, idle], args[5][:, idle])
        assert torch.equal(got[2][:, idle], args[6][:, idle])


@pytest.mark.parametrize("wavefront", [False, True])
def test_stack_kernel_cuda_graph_capture(cuda, wavefront):
    """lstm_stack_fused and lstm_stack_wavefront_fused at 2x512 (16, 64),
    each captured once in a CUDA graph (the call does no setup and no
    synchronization; its cooperative launch is captured), replayed on new
    inputs copied into the captured buffers: equal to the eager call, bit
    for bit."""
    fused = K.lstm_stack_wavefront_fused if wavefront else K.lstm_stack_fused
    args, _ = _stack_case(16, 64, 512, 2, 1, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused(*args)
    new, _ = _stack_case(16, 64, 512, 2, 2, cuda)
    for i in (0, 1, 5, 6):
        args[i].copy_(new[i])
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, fused(*args)):
        assert torch.equal(a, b)


def test_stack_wrapper_reads_state_in_place(cuda):
    """After its first call on the device the stack wrapper allocates its two
    results (the outputs and one tensor of state planes) and nothing else:
    no copy or clone of h0/c0 (the kernel reads them in place), which it
    leaves untouched."""
    args, _ = _stack_case(16, 64, 512, 2, 3, cuda)
    h0, c0 = args[5].clone(), args[6].clone()
    K.lstm_stack_fused(*args)
    torch.cuda.synchronize()
    for fused in (K.lstm_stack_fused, K.lstm_stack_wavefront_fused):
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        out = fused(*args)
        assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 2
        assert out[1].data_ptr() != args[5].data_ptr() and out[2].data_ptr() != args[6].data_ptr()
    torch.cuda.synchronize()
    assert torch.equal(args[5], h0) and torch.equal(args[6], c0)


def _lbs_case(n, seed, device):
    """Normalized random weights (V=6890, J=52), random rotations, metre-scale
    translations and vertices."""
    g = torch.Generator().manual_seed(seed)
    v, j = 6890, 52
    weights = torch.rand(v, j, generator=g)
    weights /= weights.sum(1, keepdim=True)
    q = torch.nn.functional.normalize(torch.randn(n, j, 4, generator=g), dim=-1)
    w_, x_, y_, z_ = q.unbind(-1)
    R = torch.stack([1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - w_ * z_), 2 * (x_ * z_ + w_ * y_),
                     2 * (x_ * y_ + w_ * z_), 1 - 2 * (x_ * x_ + z_ * z_), 2 * (y_ * z_ - w_ * x_),
                     2 * (x_ * z_ - w_ * y_), 2 * (y_ * z_ + w_ * x_), 1 - 2 * (x_ * x_ + y_ * y_)],
                    -1).reshape(n, j, 3, 3).to(device)
    t = torch.randn(n, j, 3, generator=g).to(device)
    v_posed = torch.randn(n, v, 3, generator=g).to(device)
    return weights, R, t, v_posed


@pytest.mark.parametrize("n", [512, 64, 1, 7, 76, 600])
def test_lbs_kernel_matches_plain_full_mesh(cuda, n):
    """The LBS kernel at the full mesh (V=6890, J=52), normalized random
    weights, random rotations: atol 2e-5, one launch; N=7 and 76 end in a
    ragged chunk, N=1 runs the one-frame tile."""
    weights, R, t, v_posed = _lbs_case(n, n, cuda)
    launches = SK.LBS_LAUNCHES
    got = SK.FusedLBS(weights.numpy(), cuda)(R, t, v_posed)
    assert SK.LBS_LAUNCHES == launches + 1
    want = SK.lbs_apply_plain(weights.to(cuda), R, t, v_posed)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_lbs_kernel_refuses_strided_transforms(cuda):
    """A strided R_glob is refused with ValueError before any launch."""
    weights, R, t, v_posed = _lbs_case(8, 3, cuda)
    lbs = SK.FusedLBS(weights.numpy(), cuda)
    launches = SK.LBS_LAUNCHES
    with pytest.raises(ValueError, match="contiguous"):
        lbs(R[::2], t[::2], v_posed[:4])
    assert SK.LBS_LAUNCHES == launches


def test_lbs_kernel_cuda_graph_capture(cuda):
    """FusedLBS.__call__ captured once in a CUDA graph (the call does no
    setup and no synchronization), replayed on new inputs copied into the
    captured buffers: equal to the eager call, bit for bit."""
    weights, R, t, v_posed = _lbs_case(64, 4, cuda)
    lbs = SK.FusedLBS(weights.numpy(), cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lbs(R, t, v_posed)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lbs(R, t, v_posed)
    _, R2, t2, v2 = _lbs_case(64, 5, cuda)
    R.copy_(R2)
    t.copy_(t2)
    v_posed.copy_(v2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, lbs(R2, t2, v2))


def test_smpl_layer_fk_one_launch(cuda):
    """SMPLLayer.fk at the full mesh: one LBS launch per call; vertices equal
    the same layer on the CPU within 1e-4 and joints equal fk_joints."""
    model = _synthetic_smplh()
    rng = np.random.RandomState(0)
    args = [(rng.randn(40, d) * s).astype(np.float32) for d, s in ((63, 0.3), (10, 0.5), (3, 0.5), (3, 1.0))]
    layer = SMPLLayer(model, cuda)
    launches = SK.LBS_LAUNCHES
    verts, joints = layer.fk(*args)
    assert SK.LBS_LAUNCHES == launches + 1
    cpu_verts, _ = SMPLLayer(model, "cpu").fk(*args)
    np.testing.assert_allclose(verts.cpu().numpy(), cpu_verts.numpy(), atol=ATOL)
    torch.testing.assert_close(joints, layer.fk_joints(*args), atol=1e-6, rtol=0)
    assert torch.isfinite(layer.vertex_normals(verts)).all()


def _bidi_case(f, n, h, seed, cuda):
    """Operands of the bidirectional layer kernel at hidden size h: 0-length
    rows (one at least where N > 1), partial and full rows, non-zero state."""
    g = torch.Generator().manual_seed(seed)
    x_proj = (torch.randn(f, 2, n, 4 * h, generator=g) * 0.5).to(cuda)
    w_hh2 = ((torch.rand(2, h, 4 * h, generator=g) * 2 - 1) * h ** -0.5).to(cuda)
    h0, c0 = (torch.randn(2, 2, n, h, generator=g) * 0.5).to(cuda)
    lengths = torch.randint(1, f, (n,), generator=g)
    idle = max(n // 16, 1) if n > 1 else 0
    lengths[:idle] = 0
    lengths[idle: idle + n // 3] = f
    mask = (torch.arange(f)[:, None] < lengths[None]).float().to(cuda)
    return x_proj, mask, w_hh2, h0, c0, (lengths == 0).to(cuda)


@pytest.mark.parametrize("f, n, h", [(16, 64, 512), (256, 64, 512), (16, 1, 512), (33, 7, 512),
                                     (3, 1300, 512), (16, 32, 1024), (16, 7, 64), (16, 64, 260),
                                     (16, 7, 516)])
def test_bidi_kernel_matches_plain_released_shape(cuda, f, n, h):
    """The bidirectional layer kernel at the released BiRNN width (and at the
    default H=1024, one launch per direction), 0-length, partial and full
    rows, non-zero state: atol 1e-4, 0-length rows frozen bit for bit, the
    launches of its plan, and a second call bit for bit equal to the first;
    (3, 1300) has more rows than one staging holds (a ring of 16-row slots).
    H=64 runs U=8 with fewer float4 columns than lanes; H=260 and 516 run
    the U=4 instance, both directions in one grid and one per launch."""
    x_proj, mask, w_hh2, h0, c0, idle = _bidi_case(f, n, h, f + n, cuda)
    plan = K.lstm_bidi_plan(n, h)
    assert plan.launches == (2 if h in (1024, 516) else 1)
    assert plan.units == (4 if h % 8 else 8)
    launches = K.BIDI_LAUNCHES
    got = K.lstm_bidi_fused(x_proj, mask, w_hh2, h0, c0)
    again = K.lstm_bidi_fused(x_proj, mask, w_hh2, h0, c0)
    assert K.BIDI_LAUNCHES == launches + 2 * plan.launches
    want = K.lstm_bidi_plain(x_proj, mask, w_hh2, h0, c0)
    for a, b, c in zip(got, want, again):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
        assert torch.equal(a, c)
    assert torch.equal(got[1][:, idle], h0[:, idle]) and torch.equal(got[2][:, idle], c0[:, idle])


@pytest.mark.parametrize("h", [512, 1024])
def test_bidi_kernel_cuda_graph_capture(cuda, h):
    """lstm_bidi_fused captured once in a CUDA graph (the call does no setup
    and no synchronization; its cooperative launches are captured), replayed
    on new inputs copied into the captured buffers: equal to the eager call,
    bit for bit."""
    x_proj, mask, w_hh2, h0, c0, _ = _bidi_case(16, 64, h, 1, cuda)
    args = (x_proj, mask, w_hh2, h0, c0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.lstm_bidi_fused(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.lstm_bidi_fused(*args)
    new = _bidi_case(16, 64, h, 2, cuda)
    for dst, src in zip((x_proj, mask, h0, c0), (new[0], new[1], new[3], new[4])):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, K.lstm_bidi_fused(*args)):
        assert torch.equal(a, b)


def _pair_case(f, n, cuda, h=512):
    """Operands of the training pair at hidden size h: 0-length rows 0-1 and
    full rows 2-5 where N allows; the one row of N=1 runs every step."""
    g = torch.Generator().manual_seed(f + n)
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)
    x_proj, w_hh = r(f, n, 4 * h) * 0.5, r(h, 4 * h) * h ** -0.5
    h0, c0 = r(n, h) * 0.5, r(n, h) * 0.5
    if n == 1:
        lengths = torch.full((1,), f)
    else:
        lengths = torch.randint(1, f, (n,), generator=g)
        lengths[:2], lengths[2:6] = 0, f
    mask = (torch.arange(f)[:, None] < lengths[None]).float().to(cuda)
    return x_proj, mask, w_hh, h0, c0, r(f, n, h), r(f, n, h), (lengths == 0).to(cuda)


@pytest.mark.parametrize("f, n, h", [(64, 16, 512), (256, 64, 512), (33, 7, 512), (64, 100, 512),
                                     (1, 1, 512), (3, 1300, 512), (64, 32, 1024), (16, 25, 1024),
                                     (3, 1300, 1024)])
def test_training_pair_matches_plain_released_shape(cuda, f, n, h):
    """Both sweeps at the released H=512 (and at H=1024) against their plain
    versions (atol 1e-4 relative to each output's largest entry), 0-length
    rows bit for bit (h_all and c_all frozen at h0, c0), and a second launch
    of each sweep bit for bit equal to the first; (64, 100) has more rows
    than one staging of either sweep holds (the forward sweep cycles them
    through a ring), (33, 7) is ragged; at (64, 100) and (3, 1300) the
    reverse sweep keeps its step operands and carries in device memory, and
    at (3, 1300) the forward sweep too (1300 rows would not fit in shared
    memory). At H=1024 from N=25 on the forward sweep's ring has one slot."""
    x_proj, mask, w_hh, h0, c0, dh, dc, idle = _pair_case(f, n, cuda, h)
    launches = TK.FWD_LAUNCHES
    got = TK.lstm_train_fwd(x_proj, mask, w_hh, h0, c0)
    again = TK.lstm_train_fwd(x_proj, mask, w_hh, h0, c0)
    assert TK.FWD_LAUNCHES == launches + 2
    want = TK.lstm_train_fwd_plain(x_proj, mask, w_hh, h0, c0)
    for a, b, c in zip(got, want, again):
        torch.testing.assert_close(a, b, atol=ATOL * float(b.abs().max()), rtol=0)
        assert torch.equal(a, c)
    assert torch.equal(got[1][:, idle], h0[idle].expand(f, -1, -1))
    assert torch.equal(got[2][:, idle], c0[idle].expand(f, -1, -1))
    c_prev = torch.cat([c0[None], want[2][:-1]])
    launches = TK.BWD_LAUNCHES
    got_b = TK.lstm_train_bwd(dh, dc, want[0], c_prev, mask, w_hh)
    again = TK.lstm_train_bwd(dh, dc, want[0], c_prev, mask, w_hh)
    assert TK.BWD_LAUNCHES == launches + 2
    want_b = TK.lstm_train_bwd_plain(dh, dc, want[0], c_prev, mask, w_hh)
    for a, b, c in zip(got_b, want_b, again):
        torch.testing.assert_close(a, b, atol=ATOL * float(b.abs().max()), rtol=0)
        assert torch.equal(a, c)
    assert torch.equal(got_b[0][:, idle], torch.zeros_like(got_b[0][:, idle]))
    assert torch.equal(got_b[1][idle], want_b[1][idle]) and torch.equal(got_b[2][idle], want_b[2][idle])


def test_forward_sweep_cuda_graph_capture(cuda):
    """lstm_train_fwd captured once in a CUDA graph (the call does no setup
    and no synchronization; the cooperative launch is captured), replayed
    on new inputs copied into the captured buffers: equal to the eager call,
    bit for bit."""
    x_proj, mask, w_hh, h0, c0, _, _, _ = _pair_case(64, 16, cuda)
    args = (x_proj, mask, w_hh, h0, c0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        TK.lstm_train_fwd(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = TK.lstm_train_fwd(*args)
    new = _pair_case(64, 17, cuda)
    x_proj.copy_(new[0][:, :16])
    h0.copy_(new[3][:16])
    c0.copy_(new[4][:16])
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, TK.lstm_train_fwd(*args)):
        assert torch.equal(a, b)


def test_reverse_sweep_cuda_graph_capture(cuda):
    """lstm_train_bwd captured once in a CUDA graph (the call does no setup
    and no synchronization; the cooperative launch is captured), replayed
    on new inputs copied into the captured buffers: equal to the eager call,
    bit for bit."""
    x_proj, mask, w_hh, h0, c0, dh, dc, _ = _pair_case(64, 16, cuda)
    gates, _, c_all = TK.lstm_train_fwd_plain(x_proj, mask, w_hh, h0, c0)
    c_prev = torch.cat([c0[None], c_all[:-1]])
    args = (dh, dc, gates, c_prev, mask, w_hh)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        TK.lstm_train_bwd(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = TK.lstm_train_bwd(*args)
    new = _pair_case(64, 17, cuda)
    dh.copy_(new[5][:, :16])
    dc.copy_(new[6][:, :16])
    gates.mul_(0.5)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, TK.lstm_train_bwd(*args)):
        assert torch.equal(a, b)


def _synthetic_smplh():
    npz = make_synthetic_smplh(seed=0)
    pd = npz["posedirs"]
    return SMPLHModel(
        v_template=npz["v_template"].astype(np.float32),
        shapedirs=npz["shapedirs"][..., :10].astype(np.float32),
        posedirs=pd.reshape(-1, pd.shape[-1]).T.astype(np.float32),
        j_regressor=npz["J_regressor"].astype(np.float32),
        weights=npz["weights"].astype(np.float32),
        parents=tuple(int(p) if p < 2 ** 31 else -1 for p in npz["kintree_table"][0]),
        faces=npz["f"].astype(np.int64))


def _synthetic_sensor():
    return SensorSMPL(_synthetic_smplh())


@pytest.mark.parametrize("m_type, hidden, bidirectional, per_step", [
    ("ief", 512, False, 1), ("rnn", 512, True, 2), ("rnn", 1024, False, 2),
    ("rnn", 1024, True, 4)], ids=["lgd_rnn", "birnn", "rnn_1024", "birnn_1024"])
def test_served_step_matches_plain_lstm_forward(cuda, m_type, hidden, bidirectional, per_step):
    """Two batched serving steps at full width: one launch of the stack
    kernel per step for LGD-RNN, one of the bidirectional kernel per layer
    for the BiRNN; at the default width 2x1024 one stack launch per layer
    (unidirectional) and one bidirectional launch per direction and layer;
    poses equal the same model with the plain LSTM."""
    if m_type == "ief":
        config = dict(m_type="ief", m_rnn_init=True, m_use_gradient=True, m_num_iterations=2,
                      m_rnn_hidden_size=512, m_rnn_num_layers=2)
    else:
        config = dict(m_type="rnn", m_bidirectional=bidirectional,
                      m_estimate_shape=bidirectional, m_shape_hidden_size=256)
    config = Configuration.from_dict(dict(config, m_average_shape=True, m_hidden_size=hidden,
                                          m_num_layers=2, use_marker_pos=True,
                                          use_marker_ori=True, n_markers=6))
    model = create_model(config, _synthetic_sensor())
    init_parameters(model, torch.Generator().manual_seed(0)).to(cuda)
    ref_model = copy.deepcopy(model)
    ref_model.rnn.lstm_stack = K.lstm_stack_plain
    ref_model.rnn.lstm_bidi = K.lstm_bidi_plain
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
        launches = K.LAUNCHES + K.BIDI_LAUNCHES
        got = served.step()
        assert K.LAUNCHES + K.BIDI_LAUNCHES == launches + per_step
        want = ref.step()
        assert K.LAUNCHES + K.BIDI_LAUNCHES == launches + per_step
        assert sorted(got) == sorted(want)
        for s in want:
            for k in want[s]:
                np.testing.assert_allclose(got[s][k], want[s][k], atol=ATOL)


# ---------------------------------------------------------------------------
# The high and default modes: the kernels' bf16 tensor-core branches. HIGH is
# held at atol 1e-4 as HIGHEST, and closer to its plain version at high than
# to the plain version at highest; DEFAULT at bf16's step: a 1-ulp
# difference in h rounds an element of the next step's bf16 h the other way.
# These cases draw x0_proj/x_proj directly (0.5 N(0, 1)), larger gate inputs
# than chip_smoke.py's projected ones, so 5e-4: above its TOL_DEFAULT (3e-4,
# set by its --mode-rounding study).
MODE_ATOL = {"high": ATOL, "default": 5e-4}


def _closer_at_high(got, plain, args):
    """At high: the kernel's outputs lie closer to the plain version at high
    than to the plain version at highest (both 0 where no row runs, as at
    N=1 here, whose row is a 0-length one)."""
    err = lambda want: max(float((a - b).abs().max()) for a, b in zip(got, want))
    at_high, at_highest = err(plain(*args, "high")), err(plain(*args, "highest"))
    assert at_high < at_highest or at_high == at_highest == 0.0


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("f, n, h, layers", [(16, 64, 512, 2), (16, 1, 512, 2), (33, 7, 512, 2),
                                             (3, 1300, 512, 2), (16, 64, 1024, 1),
                                             (16, 7, 260, 3)])
def test_stack_kernel_at_mode_matches_plain(cuda, mode, f, n, h, layers):
    """The stack kernel and (from 2 layers) its wavefront schedule at the
    mode against their plain versions at the same mode, one launch per call,
    0-length rows frozen bit for bit, a second call bit for bit."""
    args, idle = _stack_case(f, n, h, layers, f + n, cuda)
    pairs = [(K.lstm_stack_fused, K.lstm_stack_plain)]
    if layers > 1:
        pairs.append((K.lstm_stack_wavefront_fused, K.lstm_stack_wavefront_plain))
    for fused, plain in pairs:
        got, again, want = fused(*args, mode), fused(*args, mode), plain(*args, mode)
        for a, b, c in zip(got, want, again):
            torch.testing.assert_close(a, b, atol=MODE_ATOL[mode], rtol=0)
            assert torch.equal(a, c)
        if mode == "high":
            _closer_at_high(got, plain, args)
        h0, c0 = args[5], args[6]
        assert torch.equal(got[1][:, idle], h0[:, idle]) and torch.equal(got[2][:, idle],
                                                                           c0[:, idle])


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("f, n, h", [(16, 64, 512), (16, 1, 512), (3, 1300, 512), (16, 32, 1024),
                                     (16, 7, 516)])
def test_bidi_kernel_at_mode_matches_plain(cuda, mode, f, n, h):
    x_proj, mask, w_hh2, h0, c0, idle = _bidi_case(f, n, h, f + n, cuda)
    args = (x_proj, mask, w_hh2, h0, c0)
    launches = K.MODE_LAUNCHES.get(("lstm_bidi", mode), 0)
    got, again = K.lstm_bidi_fused(*args, mode), K.lstm_bidi_fused(*args, mode)
    assert K.MODE_LAUNCHES[("lstm_bidi", mode)] == launches + 2 * K.lstm_bidi_plan(
        n, h, precision=mode).launches
    for a, b, c in zip(got, K.lstm_bidi_plain(*args, mode), again):
        torch.testing.assert_close(a, b, atol=MODE_ATOL[mode], rtol=0)
        assert torch.equal(a, c)
    if mode == "high":
        _closer_at_high(got, K.lstm_bidi_plain, args)
    assert torch.equal(got[1][:, idle], h0[:, idle]) and torch.equal(got[2][:, idle], c0[:, idle])


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("kernel", ["stack", "wavefront", "bidi"])
def test_kernels_at_mode_cuda_graph_capture(cuda, mode, kernel):
    """Each wrapper at the mode (its weight split included) captured once in
    a CUDA graph and replayed on new inputs: equal to the eager call, bit
    for bit."""
    if kernel == "bidi":
        x_proj, mask, w_hh2, h0, c0, _ = _bidi_case(16, 64, 512, 1, cuda)
        args, fused, fresh = [x_proj, mask, w_hh2, h0, c0], K.lstm_bidi_fused, (0, 3)
        new = _bidi_case(16, 64, 512, 2, cuda)
    else:
        args, _ = _stack_case(16, 64, 512, 2, 1, cuda)
        args, fresh = list(args), (0, 5)
        fused = K.lstm_stack_wavefront_fused if kernel == "wavefront" else K.lstm_stack_fused
        new = _stack_case(16, 64, 512, 2, 2, cuda)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused(*args, mode)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused(*args, mode)
    for i in fresh:
        args[i].copy_(new[i])
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, fused(*args, mode)):
        assert torch.equal(a, b)


# The bidirectional layer's HIGH and DEFAULT body (bf16 exchange written
# once by its owner, chunks streamed by bulk copies) on chip_smoke.py's
# inputs: layer 0 of a BiRNN (input 72, uniform weights of bound H^-0.5),
# its input projections at the mode, so its tolerances (TOL_HIGH, TOL_DEFAULT
# there, set by its --mode-rounding study) hold.
BIDI_MODE_TOL = {"high": 7e-7, "default": 3e-4}


def _bidi_projected_case(f, n, h, mode, seed, cuda):
    """The kernel's operands (x_proj, mask, w_hh2, h0, c0) and its 0-length
    rows: 0-length (one at least where N > 1), partial and full rows."""
    from empose_tpu_torch.nn.layers import _reverse_by_length
    from empose_tpu_torch.ops.precision import matmul_at

    g = torch.Generator().manual_seed(seed)
    u = lambda *s: ((torch.rand(*s, generator=g) * 2 - 1) * h ** -0.5).to(cuda)
    cells = [dict(w_ih=u(72, 4 * h), w_hh=u(h, 4 * h), b_ih=u(4 * h), b_hh=u(4 * h))
             for _ in range(2)]
    x = torch.randn(f, n, 72, generator=g).to(cuda)
    lengths = torch.randint(1, f, (n,), generator=g)
    idle = max(n // 16, 1) if n > 1 else 0
    lengths[:idle] = 0
    lengths[idle: idle + n // 3] = f
    lengths = lengths.to(cuda)
    mask = (torch.arange(f, device=cuda)[:, None] < lengths[None]).float()
    h0, c0 = (torch.randn(2, 2, n, h, generator=g) * 0.5).to(cuda)
    x_rev = _reverse_by_length(x, lengths)
    x_proj = torch.stack([matmul_at(xs, c["w_ih"], mode) + c["b_ih"] + c["b_hh"]
                          for c, xs in zip(cells, (x, x_rev))], dim=1).contiguous()
    w_hh2 = torch.stack([c["w_hh"] for c in cells])
    return (x_proj, mask, w_hh2, h0, c0), lengths == 0


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("f, n, h", [(16, 64, 512), (16, 17, 512), (33, 1, 512), (16, 33, 1024),
                                     (16, 20, 516)])
def test_bidi_mode_body_matches_plain(cuda, mode, f, n, h):
    """The bidirectional layer at the mode against its plain version at the
    same mode within BIDI_MODE_TOL (at high also closer to it than to the
    plain version at highest), the launches of its plan, 0-length rows
    frozen bit for bit, a second call bit for bit. H=516 (U=4, one direction
    per launch) has columns past H in its k-step tiles."""
    args, idle = _bidi_projected_case(f, n, h, mode, f + n + h, cuda)
    launches = K.MODE_LAUNCHES.get(("lstm_bidi", mode), 0)
    got, again = K.lstm_bidi_fused(*args, mode), K.lstm_bidi_fused(*args, mode)
    assert K.MODE_LAUNCHES[("lstm_bidi", mode)] == launches + 2 * K.lstm_bidi_plan(
        n, h, precision=mode).launches
    for a, b, c in zip(got, K.lstm_bidi_plain(*args, mode), again):
        torch.testing.assert_close(a, b, atol=BIDI_MODE_TOL[mode], rtol=0)
        assert torch.equal(a, c)
    if mode == "high":
        _closer_at_high(got, K.lstm_bidi_plain, args)
    h0, c0 = args[3], args[4]
    assert torch.equal(got[1][:, idle], h0[:, idle]) and torch.equal(got[2][:, idle], c0[:, idle])


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("f, n, h", [(16, 33, 512), (16, 17, 1024), (16, 20, 516)])
def test_bidi_mode_graph_capture_scratch(cuda, mode, f, n, h):
    """The bidirectional layer at the mode captured in a CUDA graph where
    its exchange buffer (the bf16 scratch, allocated by the wrapper inside
    the capture from the graph's pool, never zeroed by the host) has rows
    past N (and at H=516 columns past H): replays on new inputs equal the
    eager call bit for bit, twice in a row (every launch writes the
    exchange's zeros and h0's bf16 form anew)."""
    args, _ = _bidi_projected_case(f, n, h, mode, 3, cuda)
    args = list(args)
    x_proj, h0 = args[0].clone(), args[3].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.lstm_bidi_fused(*args, mode)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.lstm_bidi_fused(*args, mode)
    for scale in (0.5, -1.5):
        args[0].copy_(x_proj * scale)
        args[3].copy_(h0 * scale)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, K.lstm_bidi_fused(*args, mode)):
            assert torch.equal(a, b)


def test_bidi_smem_formulas_agree(cuda):
    """The C layout (``lstm_bidi_smem_bytes``, which the launch holds the
    plan's bytes to) equals ``bidi_smem_bytes`` at every mode, and every
    plan's bytes are the C layout's."""
    K.lstm_bidi_prepare(cuda)
    for mode, code in (("highest", 0), ("high", 1), ("default", 2)):
        for h in (64, 260, 512, 516, 1024):
            units = 8 if h % 8 == 0 else 4
            for rows in (16, 32, 64, 128):
                assert K._bidi_lib.lstm_bidi_smem_bytes(units, h, rows, code) == \
                    K.bidi_smem_bytes(units, h, rows, mode)
            for n in (1, 17, 64, 81, 1300):
                plan = K.lstm_bidi_plan(n, h, *K.bidi_limits(cuda), precision=mode)
                assert K._bidi_lib.lstm_bidi_smem_bytes(units, h, plan.stage_rows, code) == \
                    plan.smem_bytes


# The stack order's HIGH and DEFAULT body (a bf16 exchange of each layer's
# state written once by its owner, chunks streamed by bulk copies, two teams
# of 4 warps) on chip_smoke.py's inputs: a stack of input 72, uniform weights
# of bound H^-0.5, the layer-0 projection at the mode, so its tolerances
# (BIDI_MODE_TOL: TOL_HIGH and TOL_DEFAULT there) hold.
def _stack_projected_case(f, n, h, layers, mode, seed, cuda):
    """The stack kernel's operands at the mode (x0_proj, mask, w_hh,
    w_ih_up, b_up, h0, c0) and its 0-length rows: 0-length (one at least
    where N > 1), partial and full rows."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: ((torch.rand(*s, generator=g) * 2 - 1) * h ** -0.5).to(cuda)
    cells = [dict(w_ih=u(72 if l == 0 else h, 4 * h), w_hh=u(h, 4 * h), b_ih=u(4 * h),
                  b_hh=u(4 * h)) for l in range(layers)]
    x = torch.randn(f, n, 72, generator=g).to(cuda)
    lengths = torch.randint(1, f, (n,), generator=g)
    idle = max(n // 16, 1) if n > 1 else 0
    lengths[:idle] = 0
    lengths[idle: idle + n // 3] = f
    mask = (torch.arange(f)[:, None] < lengths[None]).float().to(cuda)
    h0, c0 = (torch.randn(2, layers, n, h, generator=g) * 0.5).to(cuda)
    x0_proj, w_hh, w_ih_up, b_up = K.stack_operands(cells, x, mode)
    return (x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0), (lengths == 0).to(cuda)


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("f, n, h, layers", [(16, 64, 512, 2), (16, 17, 512, 2), (33, 1, 512, 2),
                                             (16, 33, 1024, 1), (16, 1, 1024, 1),
                                             (16, 20, 260, 2), (16, 7, 64, 3), (16, 48, 448, 3),
                                             (16, 64, 1024, 1)])
def test_stack_ring_body_matches_plain(cuda, mode, f, n, h, layers):
    """The stack kernel at the mode against its plain version at the same
    mode within BIDI_MODE_TOL (at high also closer to it than to the plain
    version at highest), one launch per call, 0-length rows frozen bit for
    bit, a second call bit for bit. The plans cover two teams (N > 16) and
    one (N <= 16; one layer of 1024 at high, one ring slot), three layers,
    H=260 (columns past H in the k-step tiles), at 3x448 N=48 at high
    two teams on two slots with two items a chunk and three chunks (a
    team's next item past what its own products issue), and one layer of
    1024 at N=64 at default (two teams on four slots: no count of the items
    issued, a slot's items staying with one team)."""
    args, idle = _stack_projected_case(f, n, h, layers, mode, f + n + h, cuda)
    launches = K.MODE_LAUNCHES.get(("lstm_stack", mode), 0)
    got, again = K.lstm_stack_fused(*args, mode), K.lstm_stack_fused(*args, mode)
    assert K.MODE_LAUNCHES[("lstm_stack", mode)] == launches + 2
    for a, b, c in zip(got, K.lstm_stack_plain(*args, mode), again):
        torch.testing.assert_close(a, b, atol=BIDI_MODE_TOL[mode], rtol=0)
        assert torch.equal(a, c)
    if mode == "high":
        _closer_at_high(got, K.lstm_stack_plain, args)
    h0, c0 = args[5], args[6]
    assert torch.equal(got[1][:, idle], h0[:, idle]) and torch.equal(got[2][:, idle], c0[:, idle])


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("f, n, h, layers", [(16, 33, 512, 2), (16, 17, 1024, 1),
                                             (16, 20, 260, 2)])
def test_stack_ring_body_graph_capture_scratch(cuda, mode, f, n, h, layers):
    """The stack kernel at the mode captured in a CUDA graph where its
    exchange buffer (the bf16 scratch, allocated by the wrapper inside the
    capture from the graph's pool, never zeroed by the host) has rows past N
    (and at H=260 columns past H): replays on new inputs equal the eager
    call bit for bit, twice in a row (every launch writes the exchange's
    zeros and h0's bf16 form anew)."""
    args, _ = _stack_projected_case(f, n, h, layers, mode, 3, cuda)
    args = list(args)
    x0_proj, h0 = args[0].clone(), args[5].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.lstm_stack_fused(*args, mode)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.lstm_stack_fused(*args, mode)
    for scale in (0.5, -1.5):
        args[0].copy_(x0_proj * scale)
        args[5].copy_(h0 * scale)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, K.lstm_stack_fused(*args, mode)):
            assert torch.equal(a, b)


# The wavefront order's HIGH and DEFAULT body: the stack order's write-once
# exchange and ring, each staged state copied once a phase and held in its
# slot until both of its products are done; on chip_smoke.py's inputs, so
# BIDI_MODE_TOL (its TOL_HIGH and TOL_DEFAULT) holds, as for the stack order.
@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("f, n, h, layers", [(16, 64, 512, 2), (16, 17, 512, 2), (33, 1, 512, 2),
                                             (3, 1300, 512, 2), (16, 48, 448, 3),
                                             (16, 64, 448, 3), (16, 48, 352, 4), (16, 7, 64, 3),
                                             (16, 20, 260, 2)])
def test_wavefront_ring_body_matches_plain(cuda, mode, f, n, h, layers):
    """The wavefront at the mode against its plain version at the same mode
    within BIDI_MODE_TOL (at high also closer to it than to the plain
    version at highest), one launch per call, 0-length rows frozen bit for
    bit, a second call bit for bit. The plans: 2x512 N=64 two teams on three
    slots keeping the count of the items issued (high) and on eight without
    it (default); N=17 two teams; N=1 and 1300 (one team; 82 chunks); three
    items a chunk at 3x448 (two teams on eight slots at default, the count
    kept from N=49; one team on two slots at high) and four at 4x352; one
    chunk at 3x64; columns past H at 2x260."""
    plan = K.lstm_stack_plan(layers, n, h, wavefront=True, precision=mode)
    assert plan.teams == (2 if n > 16 and plan.stage_rows // 16 > layers else 1)
    args, idle = _stack_projected_case(f, n, h, layers, mode, f + n + h, cuda)
    launches = K.MODE_LAUNCHES.get(("lstm_wavefront", mode), 0)
    got = K.lstm_stack_wavefront_fused(*args, mode)
    again = K.lstm_stack_wavefront_fused(*args, mode)
    assert K.MODE_LAUNCHES[("lstm_wavefront", mode)] == launches + 2
    for a, b, c in zip(got, K.lstm_stack_wavefront_plain(*args, mode), again):
        torch.testing.assert_close(a, b, atol=BIDI_MODE_TOL[mode], rtol=0)
        assert torch.equal(a, c)
    if mode == "high":
        _closer_at_high(got, K.lstm_stack_wavefront_plain, args)
    h0, c0 = args[5], args[6]
    assert torch.equal(got[1][:, idle], h0[:, idle]) and torch.equal(got[2][:, idle], c0[:, idle])


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("f, n, h, layers", [(16, 33, 512, 2), (16, 48, 352, 4),
                                             (16, 20, 260, 2)])
def test_wavefront_ring_body_graph_capture_scratch(cuda, mode, f, n, h, layers):
    """The wavefront at the mode captured in a CUDA graph where its exchange
    buffer (allocated by the wrapper inside the capture, never zeroed by the
    host) has rows past N (and at H=260 columns past H): replays on new
    inputs equal the eager call bit for bit, twice in a row."""
    args, _ = _stack_projected_case(f, n, h, layers, mode, 3, cuda)
    args = list(args)
    x0_proj, h0 = args[0].clone(), args[5].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.lstm_stack_wavefront_fused(*args, mode)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.lstm_stack_wavefront_fused(*args, mode)
    for scale in (0.5, -1.5):
        args[0].copy_(x0_proj * scale)
        args[5].copy_(h0 * scale)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, K.lstm_stack_wavefront_fused(*args, mode)):
            assert torch.equal(a, b)


# The training pair at the modes, each output against the plain version at
# the same mode relative to its largest entry: at least chip_smoke.py's
# TOL_PAIR_MODE (set by its --mode-rounding study on the smoke's inputs;
# these draw W_hh from N(0, 1/H), larger than the smoke's uniform ones).
PAIR_MODE_REL = {"high": 1e-5, "default": 5e-3}


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("f, n, h", [(64, 16, 512), (33, 7, 512), (3, 1300, 512), (64, 32, 1024),
                                     (16, 17, 512), (16, 33, 512), (16, 113, 512),
                                     (16, 17, 1024)])
def test_training_pair_at_mode_matches_plain(cuda, mode, f, n, h):
    """Both sweeps at the mode (their bf16 tensor-core branches) at the
    released shape, a ragged batch, more rows than any staging, H=1024 and
    row counts one past a 16-row chunk of the reverse sweep's ring (17, 33,
    113: the last chunk's tiles mostly zero rows)
    against their plain versions at the same mode (PAIR_MODE_REL), at high
    closer to them than to the plain versions at highest; one launch per
    call counted under the mode, 0-length rows frozen (state) or zero
    (dgates) bit for bit, a second launch bit for bit."""
    x_proj, mask, w_hh, h0, c0, dh, dc, idle = _pair_case(f, n, cuda, h)
    fwd_args = (x_proj, mask, w_hh, h0, c0, True)
    before = dict(K.MODE_LAUNCHES)
    got, again = TK.lstm_train_fwd(*fwd_args, mode), TK.lstm_train_fwd(*fwd_args, mode)
    want = TK.lstm_train_fwd_plain(*fwd_args, mode)
    c_prev = torch.cat([c0[None], want[2][:-1]])
    bwd_args = (dh, dc, want[0], c_prev, mask, w_hh)
    got_b, again_b = TK.lstm_train_bwd(*bwd_args, mode), TK.lstm_train_bwd(*bwd_args, mode)
    want_b = TK.lstm_train_bwd_plain(*bwd_args, mode)
    for sweep in ("lstm_train_fwd", "lstm_train_bwd"):
        assert K.MODE_LAUNCHES[(sweep, mode)] == before.get((sweep, mode), 0) + 2
    for outs, plain, args, rerun in ((got, TK.lstm_train_fwd_plain, fwd_args, again),
                                     (got_b, TK.lstm_train_bwd_plain, bwd_args, again_b)):
        ref = plain(*args, mode)
        for a, b, c in zip(outs, ref, rerun):
            torch.testing.assert_close(a, b, atol=PAIR_MODE_REL[mode] * float(b.abs().max()),
                                       rtol=0)
            assert torch.equal(a, c)
        if mode == "high":
            err = lambda w: max(float((a - b).abs().max()) for a, b in zip(outs, w))
            assert err(ref) < err(plain(*args, "highest"))
    assert torch.equal(got[1][:, idle], h0[idle].expand(f, -1, -1))
    assert torch.equal(got[2][:, idle], c0[idle].expand(f, -1, -1))
    assert torch.equal(got_b[0][:, idle], torch.zeros_like(got_b[0][:, idle]))


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("sweep", ["forward", "reverse"])
def test_training_pair_at_mode_cuda_graph_capture(cuda, mode, sweep):
    """Each sweep at the mode (W_hh's bf16 form made inside the capture)
    captured once in a CUDA graph and replayed on new inputs copied into
    the captured buffers: equal to the eager call, bit for bit."""
    x_proj, mask, w_hh, h0, c0, dh, dc, _ = _pair_case(64, 16, cuda)
    new = _pair_case(64, 17, cuda)
    if sweep == "forward":
        fn, args = TK.lstm_train_fwd, [x_proj, mask, w_hh, h0, c0, True, mode]
        fresh = {0: new[0][:, :16], 3: new[3][:16], 4: new[4][:16]}
    else:
        gates, _, c_all = TK.lstm_train_fwd_plain(x_proj, mask, w_hh, h0, c0, True, mode)
        c_prev = torch.cat([c0[None], c_all[:-1]])
        fn, args = TK.lstm_train_bwd, [dh, dc, gates, c_prev, mask, w_hh, mode]
        fresh = {0: new[5][:, :16], 1: new[6][:, :16], 2: gates * 0.5}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    for i, t in fresh.items():
        args[i].copy_(t)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, fn(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("f, n, h", [(16, 33, 512), (16, 17, 1024)])
def test_reverse_sweep_at_mode_graph_capture_scratch(cuda, mode, f, n, h):
    """The reverse sweep at the mode captured in a CUDA graph where its
    exchange buffer (the bf16 scratch, allocated by the wrapper inside the
    capture from the graph's pool) has zero pad rows past N: replays on new
    inputs equal the eager call bit for bit, twice in a row (the scratch's
    pad rows and slots are set anew by every launch)."""
    x_proj, mask, w_hh, h0, c0, dh, dc, _ = _pair_case(f, n, cuda, h)
    gates, _, c_all = TK.lstm_train_fwd_plain(x_proj, mask, w_hh, h0, c0, True, mode)
    c_prev = torch.cat([c0[None], c_all[:-1]])
    args = [dh, dc, gates, c_prev, mask, w_hh, mode]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        TK.lstm_train_bwd(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = TK.lstm_train_bwd(*args)
    for scale in (0.5, -1.5):
        args[0].copy_(dh * scale)
        args[2].copy_(gates * scale)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, TK.lstm_train_bwd(*args)):
            assert torch.equal(a, b)


# The forward sweep's HIGH and DEFAULT body (a bf16 exchange of h_all[t]
# written once by its owner, chunks streamed by bulk copies into a ring, two
# teams of 4 warps where a step has two chunks and the ring two slots).
@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("f, n, h", [(64, 16, 512), (256, 64, 512), (64, 100, 512),
                                     (64, 32, 1024), (16, 17, 512), (16, 33, 512),
                                     (16, 33, 516), (16, 20, 260)])
def test_forward_ring_body_matches_plain(cuda, mode, f, n, h):
    """The forward sweep at the mode against its plain version at the same
    mode (PAIR_MODE_REL), a second call bit for bit, the undifferentiated
    primal (no gates kept) with the same states bit for bit, 0-length rows
    frozen. The plans: one team (N=16; H=1024 at high, one slot and two
    chunks), two teams on 2 to 8 slots, at high N=100 five slots under seven
    chunks (a slot's chunks alternate between the teams), H=516 and H=260
    (U=2) with columns past H in the k-step tiles."""
    x_proj, mask, w_hh, h0, c0, _, _, idle = _pair_case(f, n, cuda, h)
    args = (x_proj, mask, w_hh, h0, c0, True, mode)
    before = K.MODE_LAUNCHES.get(("lstm_train_fwd", mode), 0)
    got, again = TK.lstm_train_fwd(*args), TK.lstm_train_fwd(*args)
    primal = TK.lstm_train_fwd(x_proj, mask, w_hh, h0, c0, False, mode)
    assert K.MODE_LAUNCHES[("lstm_train_fwd", mode)] == before + 3
    for a, b, c in zip(got, TK.lstm_train_fwd_plain(*args), again):
        torch.testing.assert_close(a, b, atol=PAIR_MODE_REL[mode] * float(b.abs().max()), rtol=0)
        assert torch.equal(a, c)
    assert primal[0] is None
    assert torch.equal(primal[1], got[1]) and torch.equal(primal[2], got[2])
    assert torch.equal(got[1][:, idle], h0[idle].expand(f, -1, -1))
    assert torch.equal(got[2][:, idle], c0[idle].expand(f, -1, -1))


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("f, n, h", [(16, 33, 512), (16, 17, 1024), (16, 20, 260)])
def test_forward_ring_body_graph_capture_scratch(cuda, mode, f, n, h):
    """The forward sweep at the mode captured in a CUDA graph whose pool was
    filled with NaN first (its exchange buffer, allocated by the wrapper
    inside the capture, is never set by the host, and has rows past N and at
    H=260 columns past H): replays on new inputs equal the eager call bit
    for bit, twice in a row (every launch writes the exchange's zeros and
    h0's bf16 form anew)."""
    from empose_tpu_torch.ops.precision import weight_parts

    x_proj, mask, w_hh, h0, c0, _, _, _ = _pair_case(f, n, cuda, h)
    args = [x_proj.clone(), mask, w_hh, h0.clone(), c0, True, mode, weight_parts(w_hh, mode)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        TK.lstm_train_fwd(*args)
    torch.cuda.current_stream().wait_stream(side)
    # A graph of the same pool that fills as many bytes as the sweep's
    # outputs and exchange take with NaN; its block is freed for the next.
    pool = torch.cuda.graph_pool_handle()
    poison = torch.cuda.CUDAGraph()
    words = f * n * 6 * h + 2 * 2 * -(-n // 16) * 16 * -(-h // 16) * 16
    with torch.cuda.graph(poison, pool=pool):
        torch.full((words,), float("nan"), device=cuda)
    graph = torch.cuda.CUDAGraph()
    poison.replay()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, pool=pool):
        out = TK.lstm_train_fwd(*args)
    for scale in (0.5, -1.5):
        args[0].copy_(x_proj * scale)
        args[3].copy_(h0 * scale)
        poison.replay()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, TK.lstm_train_fwd(*args)):
            assert torch.equal(a, b)


def test_forward_smem_formulas_agree(cuda):
    """The C layout of the forward sweep (``lstm_train_fwd_smem_bytes``,
    which the launch holds the plan's bytes to) equals ``fwd_smem_bytes``
    at every mode, and every plan's bytes are the C layout's."""
    TK.lstm_train_prepare(cuda)
    sms, limit = TK._prepared[torch.cuda.current_device()]
    for mode, code in (("highest", 0), ("high", 1), ("default", 2)):
        for h in (20, 260, 512, 516, 1024):
            units = TK.lstm_train_units(h, sms, mode)
            for rows in (16, 32, 64, 128):
                for teams in (1, 2):
                    assert TK._lib.lstm_train_fwd_smem_bytes(units, h, rows, code, teams) == \
                        TK.fwd_smem_bytes(units, h, rows, mode, teams)
            for n in (1, 16, 17, 64, 100, 1300):
                plan = TK.lstm_train_fwd_plan(n, h, sms, limit, mode)
                assert TK._lib.lstm_train_fwd_smem_bytes(units, h, plan.stage_rows, code,
                                                         plan.teams) == plan.smem_bytes


@pytest.mark.parametrize("mode", ["high", "default"])
def test_bidi_ring_odd_slots_matches_plain(cuda, mode):
    """The bidirectional layer on the plan whose ring has an odd slot count
    under the step's chunks: H=516 (U=4, one direction per launch) at N=96,
    five slots under six chunks at high (a slot's chunks alternate between
    the two teams: the count of the chunks issued orders their waits), six
    at default: against the plain version at the mode, a second call bit
    for bit."""
    plan = K.lstm_bidi_plan(96, 516, precision=mode)
    assert (plan.stages, plan.units) == ((5, 4) if mode == "high" else (6, 4))
    args, idle = _bidi_projected_case(16, 96, 516, mode, 96, cuda)
    got, again = K.lstm_bidi_fused(*args, mode), K.lstm_bidi_fused(*args, mode)
    for a, b, c in zip(got, K.lstm_bidi_plain(*args, mode), again):
        torch.testing.assert_close(a, b, atol=BIDI_MODE_TOL[mode], rtol=0)
        assert torch.equal(a, c)
    h0, c0 = args[3], args[4]
    assert torch.equal(got[1][:, idle], h0[:, idle]) and torch.equal(got[2][:, idle], c0[:, idle])


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("bidirectional", [False, True], ids=["rnn", "birnn"])
def test_served_step_at_mode_matches_plain_lstm(cuda, mode, bidirectional):
    """A full-width RNN and BiRNN served at the mode: their kernel launches
    at the mode only, and the poses equal the same model with the plain LSTM
    at the mode (atol 1e-4 at high; 1e-3 at default, about 10x chip_smoke.py's
    largest served reading, 9.074e-05)."""
    config = Configuration.from_dict(dict(
        m_type="rnn", m_bidirectional=bidirectional, m_estimate_shape=bidirectional,
        m_shape_hidden_size=256, m_average_shape=True, m_hidden_size=512, m_num_layers=2,
        use_marker_pos=True, use_marker_ori=True, n_markers=6))
    model = create_model(config, _synthetic_sensor())
    init_parameters(model, torch.Generator().manual_seed(0)).to(cuda)
    ref_model = copy.deepcopy(model)
    ref_model.rnn.lstm_stack = K.lstm_stack_plain
    ref_model.rnn.lstm_bidi = K.lstm_bidi_plain
    rng = np.random.RandomState(0)
    streams, chunk = 32, 16
    pos = (rng.randn(streams, chunk, 36) * 0.3).astype(np.float32)
    ori = (rng.randn(streams, chunk, 108) * 0.3).astype(np.float32)
    served = MultiStreamPredictor(model, streams, chunk)
    ref = MultiStreamPredictor(ref_model, streams, chunk)
    for p in (served, ref):
        for s in range(streams):
            p.push(s, pos[s], ori[s])
    K.MODE_LAUNCHES.clear()
    with precision_scope(mode):
        got = served.step()
        want = ref.step()
    kernel = "lstm_bidi" if bidirectional else "lstm_stack"
    assert K.MODE_LAUNCHES == {(kernel, mode): 2 if bidirectional else 1}
    for s in want:
        for k in want[s]:
            np.testing.assert_allclose(got[s][k], want[s][k],
                                       atol=ATOL if mode == "high" else 1e-3)
