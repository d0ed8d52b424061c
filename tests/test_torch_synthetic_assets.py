"""The port's asset writer (``empose_tpu_torch/tools/make_synthetic_assets.py``)
against the JAX tool (``tools/make_synthetic_assets.py``, run unedited by the
``assets_dir`` fixture of ``tests/conftest.py``: 2 recordings, 3 AMASS-like
sequences of 40 frames, seed 11) at the same arguments on the CPU.

Everything the numpy draws alone decide (the SMPL-H model, poses, shapes,
translations, masks, offsets, ids, the corpora's poses, betas, trans and
meta) is equal bit for bit. The FK joints of the corpora agree within
1e-5. The sensor fields are float32 frames built from differences of
vertices a centimetre apart on a metre-scale mesh, so each package's frames
lie up to ~4e-4 from the same frames in float64 (a thin triangle of the
synthetic mesh); two float32 implementations cannot agree within 1e-5
there. Each tree's ``sensor_pos`` and ``sensor_oris`` are therefore held
against float64 sensors of the same draws
(``make_synthetic_assets.sensors_in_float64``: the port's FK and virtual
sensors in float64): per marker, the port's distance is at most 1e-5 plus
twice the JAX tree's own distance.
"""

import glob
import os

import numpy as np
import pytest
import torch

from empose_tpu.data.emr import EMRReader as JEMRReader

from empose_tpu_torch.data.emr import EMRReader
from empose_tpu_torch.tools import make_synthetic_assets as M

torch.set_num_threads(1)

ARGS = dict(n_real_sequences=2, n_amass_sequences=3, n_frames=40, seed=11)  # conftest's
FK_TOL = 1e-5
SENSOR_FIELDS = ("sensor_pos", "sensor_oris")


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_assets"))
    M.generate_all(root, device="cpu", **ARGS)
    return root


def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**"),
                                                               recursive=True))


def _npz_files(root):
    return [f for f in _files(root) if f.endswith(".npz")]


def _emr_files(root):
    return [f for f in _files(root) if f.endswith(".emr")]


def test_same_layout_keys_dtypes_and_shapes(assets_dir, port_tree):
    assert _files(port_tree) == _files(assets_dir)
    assert "data_real/hold_out/0715_seq0_clean.npz" in _files(port_tree)
    assert os.path.isdir(os.path.join(port_tree, "experiments"))
    for rel in _npz_files(assets_dir):
        want, got = np.load(os.path.join(assets_dir, rel)), np.load(os.path.join(port_tree, rel))
        assert sorted(got.files) == sorted(want.files), rel
        for k in want.files:
            assert (got[k].dtype, got[k].shape) == (want[k].dtype, want[k].shape), (rel, k)
    for rel in _emr_files(assets_dir):
        want, got = JEMRReader(os.path.join(assets_dir, rel)), EMRReader(os.path.join(port_tree, rel))
        assert len(got) == len(want) == {"amass_emr": 3, "3dpw_emr": 2}[rel.split("/")[1]]
        for i in range(len(want)):
            assert got.fields(i) == want.fields(i)
            for f in want.fields(i):
                assert got.index[i]["fields"][f][1:] == want.index[i]["fields"][f][1:], (rel, f)


def test_draw_only_arrays_equal_bit_for_bit(assets_dir, port_tree):
    n = 0
    for rel in _npz_files(assets_dir):
        want, got = np.load(os.path.join(assets_dir, rel)), np.load(os.path.join(port_tree, rel))
        for k in want.files:
            if k not in SENSOR_FIELDS:
                assert np.array_equal(got[k], want[k]), (rel, k)
                n += 1
    assert n > 30  # the model, 3 offsets files, 3 recordings' draws
    for rel in _emr_files(assets_dir):
        want, got = JEMRReader(os.path.join(assets_dir, rel)), EMRReader(os.path.join(port_tree, rel))
        for i in range(len(want)):
            for f in ("poses", "betas", "trans"):
                assert np.array_equal(got.read(i, f), want.read(i, f)), (rel, i, f)


def test_emr_meta_equal(assets_dir, port_tree):
    for rel in _emr_files(assets_dir):
        want, got = JEMRReader(os.path.join(assets_dir, rel)), EMRReader(os.path.join(port_tree, rel))
        assert [got.meta(i) for i in range(len(got))] == [want.meta(i) for i in range(len(want))]


def test_corpus_joints_within_tolerance(assets_dir, port_tree):
    for rel in _emr_files(assets_dir):
        want, got = JEMRReader(os.path.join(assets_dir, rel)), EMRReader(os.path.join(port_tree, rel))
        for i in range(len(want)):
            np.testing.assert_allclose(got.read(i, "joints"), want.read(i, "joints"), rtol=0,
                                       atol=FK_TOL, err_msg=f"{rel} {i}")


@pytest.mark.parametrize("rel", ["data_real/0402_seq0_clean.npz", "data_real/0403_seq1_clean.npz",
                                 "data_real/hold_out/0715_seq0_clean.npz"])
def test_sensor_fields_as_close_to_float64_as_jax(assets_dir, port_tree, rel):
    pos64, ori64 = M.sensors_in_float64(assets_dir, rel, ARGS["seed"])
    want, got = np.load(os.path.join(assets_dir, rel)), np.load(os.path.join(port_tree, rel))
    f = pos64.shape[0]
    for k, ref, width in (("sensor_pos", pos64, 3), ("sensor_oris", ori64, 9)):
        jax_dist, port_dist = (np.abs(tree[k].reshape(f, 12, width) - ref).max(axis=(0, 2))
                               for tree in (want, got))
        assert jax_dist.max() < 1e-3, (k, jax_dist)  # the float64 sensors are the same sensors
        assert np.all(port_dist <= FK_TOL + 2 * jax_dist), (k, port_dist, jax_dist)
