"""The port's real-data input path and eval harness against the JAX
package: the datasets, collation, windows and loaders byte for byte, the
golden numbers of ``tests/test_golden_eval.py`` from the port, the three
eval passes against each other, the batched pass split into groups, and the
stack's one-launch decision on a card with fewer SMs.

The asset tree is ``tests/conftest.py``'s (``assets_dir``: 2 real
recordings of 40 frames and a hold-out one, 3 AMASS-style and 2 3DPW-style
sequences). Tolerances: loaders, collation and windows exactly; the golden
numbers at rtol 1e-3 (the JAX test's); batched vs serial vs host oracle at
rtol 1e-5 (fp32 sums in another order); a grouped pass vs one pass at rtol
1e-6.
"""

import os

import numpy as np
import pytest
import torch

import jax

from empose_tpu.config import Configuration as JConfiguration
from empose_tpu.data import batches as JB
from empose_tpu.data import datasets as JD
from empose_tpu.eval import harness as JH
from empose_tpu.nn.models import SensorSMPL as JSensorSMPL, create_model as j_create_model

from empose_tpu_torch import constants as C
from empose_tpu_torch.bodymodel.smplh import load_smplh
from empose_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from empose_tpu_torch.config import Configuration
from empose_tpu_torch.data import batches as B
from empose_tpu_torch.data import datasets as D
from empose_tpu_torch.eval import harness as H
from empose_tpu_torch.eval.metrics import METRIC_NAMES
from empose_tpu_torch.nn.models import SensorSMPL, create_model
from empose_tpu_torch.ops import lstm_kernel as K

torch.set_num_threads(1)

GOLDEN = {"MPJPE [mm]": 175.9676, "PA-MPJPE [mm]": 75.41331, "MPJAE [deg]": 46.56161}
GOLDEN_CFG = dict(m_type="rnn", m_bidirectional=True, m_hidden_size=32, m_num_layers=1,
                  m_estimate_shape=True, m_shape_hidden_size=16, m_average_shape=True,
                  use_marker_pos=True, use_marker_ori=True, n_markers=12, window_size=16,
                  lr=1e-3, m_fk_loss=0.0)


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    assert list(got["ids"]) == list(want["ids"])
    for k in want:
        if k != "ids":
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and np.array_equal(g, w), k


def test_real_dataset_and_collate_match_jax(assets_env):
    """RealDataset samples, collate_real (masked channels filled), the
    hold-out directory, make_real_loader and slice_window: byte for byte."""
    for data_dir in (C.data_dir_real(), os.path.join(C.data_dir_real(), "hold_out")):
        got_ds, want_ds = D.RealDataset(data_dir), JD.RealDataset(data_dir)
        assert got_ds.files == want_ds.files and len(got_ds) == len(want_ds)
        for i in range(len(got_ds)):
            g, w = got_ds[i], want_ds[i]
            for k in ("marker_pos", "marker_ori", "marker_masks", "smpl_poses", "smpl_shape",
                      "smpl_trans", "offset_means", "offset_covs", "offset_r"):
                assert np.array_equal(getattr(g, k), getattr(w, k)), k
        samples = [got_ds[i] for i in range(len(got_ds))]
        want_samples = [want_ds[i] for i in range(len(want_ds))]
        for kw in (dict(), dict(pad_multiple=16, mask_value=-1.0)):
            _assert_batches_equal(B.collate_real(samples, **kw),
                                  JB.collate_real(want_samples, **kw))
    got = list(D.make_real_loader())
    want = list(JD.make_real_loader())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
        for sf, ef in ((0, 16), (16, 32), (32, 64), (48, 70)):
            _assert_batches_equal(B.slice_window(g, sf, ef), JB.slice_window(w, sf, ef))
    with pytest.raises(FileNotFoundError):
        D.RealDataset(os.path.join(C.data_dir_real(), "missing"))


@pytest.mark.parametrize("window", [None, 16, 24])
def test_window_generator_matches_jax(assets_env, window):
    batch = B.collate_real([D.RealDataset(C.data_dir_real())[i] for i in range(2)])
    got = list(H.window_generator(batch, window))
    want = list(JH.window_generator(batch, window))
    assert len(got) == len(want)
    for (g, gn), (w, wn) in zip(got, want):
        assert gn == wn
        _assert_batches_equal(g, w)
    _assert_batches_equal(H.pad_time(batch, 80), JH.pad_time(batch, 80))


@pytest.mark.parametrize("mode", ["middle", "beginning", "random", "whole"])
def test_sequence_dataset_and_loader_match_jax(assets_env, mode):
    """EMRSequenceDataset windows through collate_amass and a shuffled Loader."""
    path = os.path.join(C.data_dir_synth(), "3dpw_emr")
    window = None if mode == "whole" else 16

    def datasets(module):
        rng = np.random.RandomState(9) if mode == "random" else None
        return module.EMRSequenceDataset(path, window_size=window,
                                         window_mode="random" if mode == "whole" else mode,
                                         rng=rng)

    got = D.Loader(datasets(D), 2, B.collate_amass, shuffle=True, seed=4, prefetch=2)
    want = JD.Loader(datasets(JD), 2, JB.collate_amass, shuffle=True, seed=4)
    assert len(got) == len(want)
    for _ in range(2):
        pairs = list(zip(got, want))
        assert len(pairs) == len(want)
        for g, w in pairs:
            _assert_batches_equal(g, w)


def _golden_session():
    j_cfg = JConfiguration.from_dict(GOLDEN_CFG)
    from empose_tpu.bodymodel.smplh import load_smplh as j_load_smplh
    params, state = j_create_model(j_cfg, JSensorSMPL(j_load_smplh())).init(
        jax.random.PRNGKey(0))
    cfg = Configuration.from_dict(GOLDEN_CFG)
    smplh = load_smplh()
    model = create_model(cfg, SensorSMPL(smplh))
    model.load_state_dict(state_dict_from_jax(jax.device_get(params), jax.device_get(state), cfg),
                          strict=True)
    return H.EvalSession(model, smplh)


def test_golden_numbers_from_the_port(assets_env):
    """The JAX seed-0 BiRNN's weights, crossed over, evaluated by the port
    over the whole sequences (padded to 32): the recorded numbers."""
    session = _golden_session()
    for kw in (dict(), dict(serial=True), dict(host_metrics=True)):
        _, overall = H.evaluate_real_sequences(session, D.make_real_loader(), None,
                                               pad_multiple=32, **kw)
        for key, want in GOLDEN.items():
            np.testing.assert_allclose(overall[key], want, rtol=1e-3, err_msg=f"{kw} {key}")


def _mixed_corpus(seed=9, lengths=(40, 17, 33, 5)):
    rng = np.random.RandomState(seed)
    m, seqs = 12, []
    for i, f in enumerate(lengths):
        masks = np.ones((1, f, m), np.float32)
        masks[0, f // 2, i % m] = 0.0
        seqs.append({
            "ids": [f"mixed_{i}"],
            "poses": (rng.randn(1, f, 66) * 0.2).astype(np.float32),
            "shapes": (rng.randn(1, 10) * 0.2).astype(np.float32),
            "trans": (rng.randn(1, f, 3) * 0.1).astype(np.float32),
            "seq_lengths": np.full(1, f, np.int32),
            "marker_pos": rng.randn(1, f, m * 3).astype(np.float32),
            "marker_ori": rng.randn(1, f, m * 9).astype(np.float32),
            "marker_nor": rng.randn(1, f, m * 3).astype(np.float32),
            "marker_masks": masks,
            "offset_t": (rng.randn(1, m, 3) * 0.02).astype(np.float32),
            "offset_r": np.broadcast_to(np.eye(3, dtype=np.float32), (1, m, 3, 3)).copy(),
        })
    return seqs


@pytest.mark.parametrize("kind", ["birnn", "lgd_rnn"])
def test_passes_agree_and_groups_equal_one_pass(assets_env, monkeypatch, kind):
    """Sequences of unequal lengths: batched == serial == host oracle row by
    row, windowed and whole (whole sequences in one group per padded
    length, so a frame-averaged shape sees the serial loop's padding); a
    corpus split into more groups by a small byte budget gives the same
    rows."""
    cfg = dict(GOLDEN_CFG, m_num_layers=2, m_hidden_size=16, m_shape_hidden_size=8)
    if kind == "lgd_rnn":
        cfg = dict(use_marker_pos=True, use_marker_ori=True, n_markers=12, window_size=8, lr=1e-3,
                   m_type="ief", m_rnn_init=True, m_use_gradient=True, m_average_shape=True,
                   m_num_iterations=1, m_hidden_size=16, m_num_layers=1, m_rnn_hidden_size=16,
                   m_rnn_num_layers=2)
    smplh = load_smplh()
    model = create_model(Configuration.from_dict(cfg), SensorSMPL(smplh))
    from empose_tpu_torch.nn.layers import init_parameters
    init_parameters(model, torch.Generator().manual_seed(2))
    session = H.EvalSession(model, smplh)
    seqs = _mixed_corpus()
    for window in (8, None):
        batched, _ = H.evaluate_real_sequences(session, seqs, window, pad_multiple=16)
        serial, _ = H.evaluate_real_sequences(session, seqs, window, pad_multiple=16, serial=True)
        host, _ = H.evaluate_real_sequences(session, seqs, window, pad_multiple=16,
                                            host_metrics=True)
        if window is None:  # one group per padded length: 16 (5), 32 (17), 48 (33, 40)
            assert [w for _, _, w in H.build_eval_corpus(seqs, None, 16)[2]] == [16, 32, 48]
        else:
            assert len(H.build_eval_corpus(seqs, window, 16)[2]) == 1
        with monkeypatch.context() as m:
            m.setattr(H, "EVAL_CORPUS_BYTES", 20_000)
            grouped, _ = H.evaluate_real_sequences(session, seqs, window, pad_multiple=16)
            groups = [g for g, _, _ in H.build_eval_corpus(seqs, window, 16)[2]]
        assert len(groups) == 4 and sorted(i for g in groups for i in g) == [0, 1, 2, 3]
        ids = [s["ids"][0] for s in seqs] + ["Overall average"]
        for rows in (batched, serial, host, grouped):
            assert [r[0] for r in rows] == ids
            assert all(len(r) == 1 + len(METRIC_NAMES) for r in rows)
        for b, s, h, g in zip(batched, serial, host, grouped):
            msg = f"{window} {b[0]}"
            np.testing.assert_allclose(s[1:], h[1:], rtol=1e-5, atol=1e-4, err_msg=msg)
            np.testing.assert_allclose(b[1:], s[1:], rtol=1e-5, atol=1e-4, err_msg=msg)
            np.testing.assert_allclose(g[1:], b[1:], rtol=1e-6, atol=1e-6, err_msg=msg)
    rows, overall = H.evaluate_real_sequences(session, [], 8)
    assert rows == [["Overall average"] + [0.0] * 6] and overall["MPJPE [mm]"] == 0.0


def test_whole_sequence_rows_equal_the_serial_loop_not_one_padded_pass(assets_env):
    """Why the port's batched pass groups whole sequences by padded length:
    a BiRNN that averages its shape estimate over the frames averages over
    the padding too, so JAX's one pass, which pads every sequence to the
    longest, gives the shorter sequences other rows than JAX's serial loop
    and its host oracle (more than 1% apart here). The shape head's weights
    are scaled by 30 so that its estimate varies from frame to frame; at its
    random initialization the estimate is nearly constant and the padding
    moves the rows by about 1e-5. The port's batched rows equal JAX's
    serial rows and its host oracle's (rtol 1e-4, the CLI tests'
    tolerance); equal-length sequences give JAX's batched rows too."""
    j_cfg = JConfiguration.from_dict(GOLDEN_CFG)
    from empose_tpu.bodymodel.smplh import load_smplh as j_load_smplh
    j_sensor = JSensorSMPL(j_load_smplh())
    j_model = j_create_model(j_cfg, j_sensor)
    params, state = j_model.init(jax.random.PRNGKey(3))
    params = dict(params, to_shape=jax.tree.map(lambda w: w * 30.0, params["to_shape"]))
    j_session = JH.EvalSession(j_model, params, state, j_sensor)
    cfg = Configuration.from_dict(GOLDEN_CFG)
    smplh = load_smplh()
    model = create_model(cfg, SensorSMPL(smplh))
    model.load_state_dict(state_dict_from_jax(jax.device_get(params), jax.device_get(state), cfg),
                          strict=True)
    session = H.EvalSession(model, smplh)
    seqs = _mixed_corpus()
    j_batched, _ = JH.evaluate_real_sequences(j_session, seqs, None, pad_multiple=16)
    j_serial, _ = JH.evaluate_real_sequences(j_session, seqs, None, pad_multiple=16, serial=True)
    j_host, _ = JH.evaluate_real_sequences(j_session, seqs, None, pad_multiple=16,
                                           host_metrics=True)
    batched, _ = H.evaluate_real_sequences(session, seqs, None, pad_multiple=16)
    assert [r[0] for r in batched] == [r[0] for r in j_serial] == [r[0] for r in j_batched]
    for got, want, oracle, one_pass in zip(batched, j_serial, j_host, j_batched):
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4, atol=1e-4, err_msg=got[0])
        np.testing.assert_allclose(got[1:], oracle[1:], rtol=1e-4, atol=1e-4, err_msg=got[0])
        if got[0] in ("mixed_1", "mixed_3"):  # 17 and 5 frames: padded to 48 in one pass
            assert np.max(np.abs(np.subtract(one_pass[1:], want[1:])) / np.abs(want[1:])) > 1e-2
    same = [seqs[0], seqs[2]]  # 40 and 33 frames: both padded to 48 either way
    np.testing.assert_allclose(
        [r[1:] for r in H.evaluate_real_sequences(session, same, None, pad_multiple=16)[0]],
        [r[1:] for r in JH.evaluate_real_sequences(j_session, same, None, pad_multiple=16)[0]],
        rtol=1e-4, atol=1e-4)


def test_stack_takes_per_layer_route_where_it_does_not_fit(monkeypatch):
    """A 2x512 stack fits one launch on an H100 SXM (132 SMs) but not on a
    114-SM card: lstm_stack then calls the stack function once per layer,
    with the same results."""
    rng = np.random.RandomState(0)
    f, n, h, layers = 3, 2, 512, 2
    cells = [{"w_ih": torch.from_numpy(rng.randn(8 if l == 0 else h, 4 * h).astype(np.float32) * 0.05),
              "w_hh": torch.from_numpy(rng.randn(h, 4 * h).astype(np.float32) * 0.05),
              "b_ih": torch.from_numpy(rng.randn(4 * h).astype(np.float32) * 0.1),
              "b_hh": torch.from_numpy(rng.randn(4 * h).astype(np.float32) * 0.1)}
             for l in range(layers)]
    x = torch.from_numpy(rng.randn(f, n, 8).astype(np.float32))
    mask = torch.ones(f, n)
    h0 = c0 = torch.zeros(layers, n, h)
    calls = []

    def counting(*args):
        calls.append(args[2].shape[0])
        return K.lstm_stack_plain(*args)

    assert K.stack_limits("cpu") == (K.SMS, K.SMEM_LIMIT)
    assert K.lstm_stack_fits(layers, h) and not K.lstm_stack_fits(layers, h, sms=114)
    whole = K.lstm_stack(cells, x, mask, h0, c0, stack_fn=counting)
    assert calls == [2]
    calls.clear()
    monkeypatch.setattr(K, "stack_limits", lambda device: (114, K.SMEM_LIMIT))
    per_layer = K.lstm_stack(cells, x, mask, h0, c0, stack_fn=counting)
    assert calls == [1, 1]
    for a, b in zip((whole[0],) + whole[1], (per_layer[0],) + per_layer[1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
